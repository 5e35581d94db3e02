"""K6: the Mamba1 selective scan, forward. Replaces the Pallas kernel
``repro/kernels/selective_scan.py::selective_scan`` (``_kernel``) with the
CUDA C++ kernel ``csrc/selective_scan.cu``.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = sum_n h_t * C_t

per batch row and channel, with the (di, N) state in f32. The TPU kernel
carries h in VMEM scratch from one grid step to the next along a sequential
sequence axis; on the card nothing carries between blocks, so one CTA owns a
(batch row, 32-channel block) for the whole sequence with h in registers
(four threads a channel, N/4 states each, y summed over N by two warp
shuffles). x/dt tiles and the B/C rows are staged in shared memory with
coalesced loads, 32 steps at a time.

Bound at the served prefill shape (B 1, S 128, di 8192, N 16, bf16): the
S * di * N = 16.8 M exponentials on the special-function units (16 per SM per
clock, 132 SMs, 1.83 GHz: ~4.3 us) against ~8 MB of inputs and outputs
(~2.4 us at 3.35 TB/s), so operations bound it. The recurrence is a serial
chain in t for each state; exp(dt * A) and dt * x * B do not depend on h and
are issued ahead of it, and four independent chains per thread keep the
pipes busy. The exponential is the accurate ``expf`` (no fast math), and each
product and sum is rounded as the plain version rounds it.

Only the forward is ported: the backward (K9, ``selective_scan_bwd``) comes
with training, and a gradient request raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import compat

Tensor = torch.Tensor

counter = compat.launch_counter("selective_scan")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIG = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# N = 4 * states per thread; the kernel is built for these
KERNEL_STATES = (4, 8, 16, 32, 64)


def _blocks(x: Tensor, chunk: int, bd: int) -> Tuple[int, int]:
    """The reference's ``chunk = min(chunk, S)``, ``bd = min(bd, di)`` and
    its alignment contract, raised as ``ValueError`` where it asserts."""
    _, s, di = x.shape
    chunk, bd = min(chunk, s), min(bd, di)
    if chunk < 1 or s % chunk or di % bd:
        raise ValueError(
            f"selective_scan: S ({s}) must be a multiple of the scan chunk "
            f"({chunk}) and d_inner ({di}) of bd ({bd}), as the reference "
            f"kernel asserts")
    return chunk, bd


def _no_grad(*tensors: Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "selective_scan is forward-only in the port: its backward (K9, "
            "selective_scan_bwd) comes with training, ROADMAP queue 1 item 13")


def selective_scan_plain(x: Tensor, dt: Tensor, b: Tensor, c: Tensor,
                         a: Tensor, h0: Tensor, *, chunk: int = 128,
                         bd: int = 512) -> Tuple[Tensor, Tensor, Tensor]:
    """The plain PyTorch version, in the reference kernel's arithmetic:
    inputs cast to f32, ``exp(dt * A)`` each step, ``h = dA * h +
    (dt * x) * B``, ``y_t = sum_n h * C`` in f32 (in the kernel's order,
    :func:`_sum_states`), y rounded to x's dtype once at the end, h
    checkpointed at each chunk start. Channels are independent, so ``bd``
    only names the reference's block."""
    chunk, bd = _blocks(x, chunk, bd)
    bt, s, di = x.shape
    n = a.shape[-1]
    f32 = torch.float32
    x32, dt32, b32, c32 = (t.to(f32) for t in (x, dt, b, c))
    a32 = a.to(f32)
    h = h0.to(f32)
    y = torch.empty((bt, s, di), dtype=f32, device=x.device)
    starts = torch.empty((bt, s // chunk, di, n), dtype=f32, device=x.device)
    for t in range(s):
        if t % chunk == 0:
            starts[:, t // chunk] = h
        da = torch.exp(dt32[:, t, :, None] * a32)
        dbx = (dt32[:, t] * x32[:, t])[..., None] * b32[:, t, None, :]
        h = da * h + dbx
        y[:, t] = _sum_states(h * c32[:, t, None, :])
    return y.to(x.dtype), h.to(h0.dtype), starts


def _sum_states(p: Tensor) -> Tensor:
    """Sum over the last (state) axis in the kernel's order: four partial
    sums of N/4 consecutive states, each taken in order, then (0 + 1) +
    (2 + 3), as the kernel's four threads of a channel and their two
    shuffles add them (in order, for N not a multiple of 4). Near a
    cancellation another order moves a bf16 y by more than its ulp."""
    n = p.shape[-1]
    lanes = 4 if n % 4 == 0 else 1
    q = p.reshape(*p.shape[:-1], lanes, n // lanes)
    acc = q[..., 0]
    for j in range(1, n // lanes):
        acc = acc + q[..., j]
    if lanes == 1:
        return acc[..., 0]
    return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])


def selective_scan(x: Tensor, dt: Tensor, b: Tensor, c: Tensor, a: Tensor,
                   h0: Tensor, *, chunk: int = 128, bd: int = 512
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """x, dt: (B, S, di); b, c: (B, S, N); a: (di, N); h0: (B, di, N).

    Returns (y (B, S, di) in x's dtype, h_final (B, di, N) in h0's dtype,
    h_starts (B, S / chunk, di, N) f32: the chunk-start states K9 will
    consume). ``chunk = min(chunk, S)`` and ``bd = min(bd, di)`` must divide
    S and di. CPU tensors take :func:`selective_scan_plain`; CUDA tensors
    launch the kernel (or raise)."""
    _no_grad(x, dt, b, c, a, h0)
    if x.device.type == "cpu":
        return selective_scan_plain(x, dt, b, c, a, h0, chunk=chunk, bd=bd)
    chunk, _ = _blocks(x, chunk, bd)
    bt, s, di = x.shape
    n = a.shape[-1]
    if (dt.shape != x.shape or b.shape != (bt, s, n) or c.shape != b.shape
            or a.shape != (di, n) or h0.shape != (bt, di, n)
            or not x.dtype == dt.dtype == b.dtype == c.dtype
            or x.dtype not in _DTYPE_CODES or n not in KERNEL_STATES):
        raise ValueError(
            f"selective_scan: unsupported operands x{tuple(x.shape)} "
            f"dt{tuple(dt.shape)} b{tuple(b.shape)} c{tuple(c.shape)} "
            f"a{tuple(a.shape)} h0{tuple(h0.shape)} {x.dtype} (N must be "
            f"one of {KERNEL_STATES})")
    a32 = a.to(torch.float32).contiguous()
    h32 = h0.to(torch.float32).contiguous()
    compat.require_cuda(x, dt, b, c, a32, h32)
    y = torch.empty_like(x)
    h_fin = torch.empty_like(h32)
    starts = torch.empty((bt, s // chunk, di, n), dtype=torch.float32,
                         device=x.device)
    lib = compat.load("selective_scan", {"selective_scan_launch": _SIG})
    err = lib.selective_scan_launch(
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
        a32.data_ptr(), h32.data_ptr(), y.data_ptr(), h_fin.data_ptr(),
        starts.data_ptr(), bt, s, di, n, chunk, _DTYPE_CODES[x.dtype],
        compat.stream_ptr(x))
    counter.bump()
    compat.check(err, "selective_scan")
    return y, h_fin.to(h0.dtype), starts
