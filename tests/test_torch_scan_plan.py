"""K6's launch plan (``selective_scan.scan_plan``), on the CPU: the grid
covers every (batch row, channel) once with all N states, and batch 1 at
falcon-mamba-7b's width (di 8192, N 16) fills the card with 24 warps an SM
or more. The kernel launches with the same plan (tests/test_torch_cuda.py
holds its C mirror to it on the card)."""
import pytest

from repro_torch.kernels import compat
from repro_torch.kernels.selective_scan import (KERNEL_STATES,
                                                SCAN_WARPS_PER_SM, scan_plan)

SHAPES = [(bt, di, n) for bt in (1, 2, 4) for di in (16, 100, 8192)
          for n in KERNEL_STATES]


@pytest.mark.parametrize("bt,di,n", SHAPES)
def test_plan_covers_every_channel_once(bt, di, n):
    plan = scan_plan(bt, di, n)
    assert plan.lanes * plan.states == n
    assert n % plan.lanes == 0 and plan.lanes * plan.channels == 128
    gx, gy = plan.grid
    assert gy == bt
    seen = {}
    for by in range(gy):
        for bx in range(gx):
            for tid in range(plan.lanes * plan.channels):
                ch = bx * plan.channels + tid // plan.lanes
                if ch >= di:
                    continue
                n0 = (tid % plan.lanes) * plan.states
                for j in range(plan.states):
                    key = (by, ch, n0 + j)
                    assert key not in seen
                    seen[key] = tid
    assert len(seen) == bt * di * n
    # no CTA lies wholly past di
    assert (gx - 1) * plan.channels < di


def test_plan_fills_the_card_at_batch_1():
    """Falcon prefill (B 1, di 8192, N 16): one state a thread, 16 lanes a
    channel, 1024 CTAs of 8 channels: 31 warps an SM, four times the 7.75
    of four threads a channel."""
    plan = scan_plan(1, 8192, 16)
    assert (plan.states, plan.lanes, plan.channels) == (1, 16, 8)
    assert plan.grid == (1024, 1)
    assert plan.warps_per_sm >= SCAN_WARPS_PER_SM
    old = 8192 // 32 * 4 / compat.SMS
    assert plan.warps_per_sm == pytest.approx(4 * old)


@pytest.mark.parametrize("bt,n,states", [(2, 16, 2), (4, 16, 2), (1, 32, 2),
                                         (1, 64, 4), (1, 4, 1), (1, 8, 1)])
def test_plan_takes_fewest_threads_that_fill(bt, n, states):
    """Fewer lanes (more states a thread) wherever they still reach the
    warp target; else the most lanes N allows."""
    plan = scan_plan(bt, 8192, n)
    assert plan.states == states
    if plan.warps_per_sm < SCAN_WARPS_PER_SM:
        assert plan.lanes == max(n // s for s in (1, 2, 4) if n % s == 0
                                 and n // s <= 16)


@pytest.mark.parametrize("n", [0, 2, 12, 128])
def test_plan_refuses_unsupported_state_sizes(n):
    with pytest.raises(ValueError):
        scan_plan(1, 8192, n)
