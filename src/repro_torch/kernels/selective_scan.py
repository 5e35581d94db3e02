"""K6 and K9: the Mamba1 selective scan, forward and backward. Replace the
Pallas kernels ``repro/kernels/selective_scan.py::selective_scan``
(``_kernel``) and ``selective_scan_bwd`` (``_bwd_kernel``) with the CUDA C++
kernels ``csrc/selective_scan.cu`` and ``csrc/selective_scan_bwd.cu``.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,   y_t = sum_n h_t * C_t

per batch row and channel, with the (di, N) state in f32. The TPU kernel
carries h in VMEM scratch from one grid step to the next along a sequential
sequence axis; on the card nothing carries between blocks, so each state's
recurrence is one thread's loop over the whole sequence with h in a
register. :func:`scan_plan` picks the geometry: states a thread, threads a
channel and channels a 128-thread CTA, so that batch 1 at falcon-mamba-7b's
width fills the card (one state a thread there, 31 warps an SM). Operands
arrive by 16-byte loads a tile ahead into a shared ring, converted to f32
once; each step writes its products h_t * C_t to a shared tile, and after
the tile's steps one thread a (step, channel) sums them into y in
:func:`_sum_states`'s order, off the recurrence's chain.

K6's bound at the served prefill shape (B 1, S 128, di 8192, N 16, bf16):
issue slots, about 16.4 instructions a (t, d, n) with the accurate expf's 8
(``chip_smoke.py``'s ``scan_fwd_issue_ms``: ~8 us), above the S * di * N =
16.8 M exponentials on the special-function units (16 per SM per clock:
~4 us) and ~8 MB of inputs and outputs (~2.4 us at 3.35 TB/s). The
exponential is the accurate ``expf`` (no fast math), and each product and
sum is rounded as the plain version rounds it, so the kernel's bits are the
plain version's.

K9 walks the chunks in reverse, one CTA a (batch row, 32-channel block),
four threads a channel with N/4 states each: from each
chunk's ``h_starts`` entry (written by K6) one forward pass keeps the state
entering every sub-tile of 128 / N steps (in a scratch buffer,
:func:`bwd_scratch_floats`), then each sub-tile, in reverse, recomputes its
h_{t-1} and exp(dt A) once into registers and runs the adjoint recurrence
over them, keeping dh and dA in registers; dB and dC come out as
per-32-channel-block partials that the wrapper sums (the reference sums
its per-d-block partials outside the kernel too).
:func:`selective_scan_trainable` is differentiable through
:class:`SelectiveScan` (K6 forward, K9 backward); :func:`selective_scan` is
forward-only, as the reference's is.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import compat

Tensor = torch.Tensor

counter = compat.launch_counter("selective_scan")
bwd_counter = compat.launch_counter("selective_scan_bwd")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGS = {
    "selective_scan_launch": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    "selective_scan_plan": [ctypes.c_int] * 3 + [ctypes.c_void_p],
}
_BWD_SIG = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# channels a K9 CTA owns: its dB/dC partials come one per block of these
BWD_CHANNELS = 32
# the state sizes N the kernels are built for
KERNEL_STATES = (4, 8, 16, 32, 64)
# K6's launch plan (csrc/selective_scan.cu::make_plan mirrors it): a CTA of
# SCAN_THREADS threads; for each N the states a thread it is built for,
# fewest threads first; the first that puts SCAN_WARPS_PER_SM warps on each
# of the card's SMs is taken, else the last
SCAN_THREADS = 128
SCAN_STATES_PER_THREAD = {4: (1,), 8: (2, 1), 16: (2, 1), 32: (2,), 64: (4,)}
SCAN_WARPS_PER_SM = 24


class ScanPlan(NamedTuple):
    states: int         # consecutive states a thread
    lanes: int          # threads a channel (N / states)
    channels: int       # channels a CTA
    grid: Tuple[int, int]   # (CTAs along di, batch rows)
    warps_per_sm: float


def scan_plan(bt: int, di: int, n: int) -> ScanPlan:
    """K6's launch geometry for a (B, di, N) scan: more lanes a channel
    (fewer states a thread) until the grid puts SCAN_WARPS_PER_SM warps on
    every SM, the kernel's steps being latency-bound with fewer."""
    if n not in SCAN_STATES_PER_THREAD:
        raise ValueError(f"selective_scan: N must be one of {KERNEL_STATES}, "
                         f"got {n}")
    for spt in SCAN_STATES_PER_THREAD[n]:
        lanes = n // spt
        ch = SCAN_THREADS // lanes
        gx = -(-di // ch)
        warps = bt * gx * SCAN_THREADS / 32 / compat.SMS
        if warps >= SCAN_WARPS_PER_SM:
            break
    return ScanPlan(spt, lanes, ch, (gx, bt), warps)


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
    (2 + 3), as K6's sum over its tile of products and K9's four threads of
    a channel and their two shuffles add them (in order, for N not a
    multiple of 4). Near a
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
    consumes). ``chunk = min(chunk, S)`` and ``bd = min(bd, di)`` must divide
    S and di. CPU tensors take :func:`selective_scan_plain`; CUDA tensors
    launch the kernel (or raise); meta tensors charge a costing trace
    (``compat.on_meta``). Forward-only, as the reference's:
    gradients go through :func:`selective_scan_trainable`."""
    compat.refuse_grad("selective_scan", x, dt, b, c, a, h0,
                       hint=" or differentiate selective_scan_trainable "
                            "(K6 + K9)")
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
    if x.device.type == "meta":
        compat.on_meta(counter, bt=bt, s=s, di=di, n=n, chunk=chunk,
                       dtype=compat.DTYPE_NAMES[x.dtype])
        return y, h_fin.to(h0.dtype), starts
    lib = compat.load("selective_scan", _SIGS)
    err = lib.selective_scan_launch(
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
        a32.data_ptr(), h32.data_ptr(), y.data_ptr(), h_fin.data_ptr(),
        starts.data_ptr(), bt, s, di, n, chunk, _DTYPE_CODES[x.dtype],
        compat.stream_ptr(x))
    counter.bump()
    compat.check(err, "selective_scan")
    return y, h_fin.to(h0.dtype), starts


def kernel_plan(bt: int, di: int, n: int) -> Tuple[int, int, int, int]:
    """The plan ``selective_scan_launch`` takes on the card for (B, di, N):
    (states a thread, lanes a channel, channels a CTA, CTAs along di), read
    from the built kernel's ``selective_scan_plan`` (the mirror of
    :func:`scan_plan`)."""
    lib = compat.load("selective_scan", _SIGS)
    out = (ctypes.c_int * 4)()
    compat.check(lib.selective_scan_plan(bt, di, n, out),
                 "selective_scan_plan")
    return tuple(out)


def _sum_channels(p: Tensor) -> Tensor:
    """(B, di, N) -> (B, ceil(di / 32), N): the sum over each block of 32
    channels in K9's order. A warp holds 8 channels, summed by three xor
    shuffles (a pairwise tree: ((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7))),
    then the block's four warps as (0 + 1) + (2 + 3). Channels past di add
    zeros."""
    bt, di, n = p.shape
    pad = -di % BWD_CHANNELS
    if pad:
        p = torch.cat([p, p.new_zeros((bt, pad, n))], dim=1)
    q = p.reshape(bt, -1, 4, 8, n)
    while q.shape[3] > 1:
        q = q[:, :, :, 0::2] + q[:, :, :, 1::2]
    w = q[:, :, :, 0]
    return (w[:, :, 0] + w[:, :, 1]) + (w[:, :, 2] + w[:, :, 3])


def selective_scan_bwd_plain(x: Tensor, dt: Tensor, b: Tensor, c: Tensor,
                             a: Tensor, h_starts: Tensor, dy: Tensor, *,
                             chunk: int = 128, bd: int = 512
                             ) -> Tuple[Tensor, Tensor, Tensor, Tensor,
                                        Tensor]:
    """The plain PyTorch version of K9, in the reference kernel's
    arithmetic: per chunk, in reverse, h recomputed forward from
    ``h_starts`` (K6's rounding), then the adjoint recurrence backwards
    (dh_t = dh + dy_t C_t; dh carried as exp(dt A) dh_t). Sums over N in
    K6's order (:func:`_sum_states`), dB/dC partials over channel blocks in
    K9's order (:func:`_sum_channels`), summed over the blocks afterwards;
    dA summed over the batch. All operands f32. Returns (dx, ddt, dB, dC,
    dA)."""
    chunk, bd = _blocks(x, chunk, bd)
    bt, s, di = x.shape
    n = a.shape[-1]
    f32 = torch.float32
    dev = x.device
    dx = torch.empty((bt, s, di), dtype=f32, device=dev)
    ddt = torch.empty_like(dx)
    n_blk = -(-di // BWD_CHANNELS)
    db_part = torch.empty((bt, s, n_blk, n), dtype=f32, device=dev)
    dc_part = torch.empty_like(db_part)
    dh = torch.zeros((bt, di, n), dtype=f32, device=dev)
    dacc = torch.zeros_like(dh)
    for k in reversed(range(s // chunk)):
        h = h_starts[:, k]
        h_prev = []
        for t in range(k * chunk, (k + 1) * chunk):
            h_prev.append(h)
            da = torch.exp(dt[:, t, :, None] * a)
            dbx = (dt[:, t] * x[:, t])[..., None] * b[:, t, None, :]
            h = da * h + dbx
        for t in reversed(range(k * chunk, (k + 1) * chunk)):
            hp = h_prev[t - k * chunk]
            da = torch.exp(dt[:, t, :, None] * a)
            coef = (dt[:, t] * x[:, t])[..., None]
            h_t = da * hp + coef * b[:, t, None, :]
            dh_t = dh + dy[:, t, :, None] * c[:, t, None, :]
            dc_part[:, t] = _sum_channels(h_t * dy[:, t, :, None])
            db_part[:, t] = _sum_channels(dh_t * coef)
            sb = _sum_states(dh_t * b[:, t, None, :])
            dx[:, t] = sb * dt[:, t]
            g = dh_t * da * hp
            ddt[:, t] = sb * x[:, t] + _sum_states(g * a)
            dacc = dacc + g * dt[:, t, :, None]
            dh = da * dh_t
    return dx, ddt, db_part.sum(dim=2), dc_part.sum(dim=2), dacc.sum(dim=0)


def bwd_scratch_floats(bt: int, di: int, n: int, chunk: int) -> int:
    """Floats of K9's start-state scratch: per (batch row, channel block),
    the state entering each sub-tile of 128 / N steps of a chunk, N / 4
    states for each of the CTA's 128 threads."""
    n_blk = -(-di // BWD_CHANNELS)
    return bt * n_blk * -(-chunk // (128 // n)) * n * BWD_CHANNELS


def selective_scan_bwd(x: Tensor, dt: Tensor, b: Tensor, c: Tensor,
                       a: Tensor, h_starts: Tensor, dy: Tensor, *,
                       chunk: int = 128, bd: int = 512
                       ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """x, dt, dy: (B, S, di); b, c: (B, S, N); a: (di, N); h_starts: (B,
    S / chunk, di, N) from the forward; all f32 -> f32 (dx, ddt, dB, dC,
    dA), exact adjoints (the gradient into h0 is zero: training starts from
    h0 = 0). CPU tensors take :func:`selective_scan_bwd_plain`; CUDA tensors
    launch K9 (or raise); meta tensors charge a costing trace."""
    if x.device.type == "cpu":
        return selective_scan_bwd_plain(x, dt, b, c, a, h_starts, dy,
                                        chunk=chunk, bd=bd)
    chunk, _ = _blocks(x, chunk, bd)
    bt, s, di = x.shape
    n = a.shape[-1]
    ops = (x, dt, b, c, a, h_starts, dy)
    if (dt.shape != x.shape or dy.shape != x.shape or b.shape != (bt, s, n)
            or c.shape != b.shape or a.shape != (di, n)
            or h_starts.shape != (bt, s // chunk, di, n)
            or any(t.dtype != torch.float32 for t in ops)
            or n not in KERNEL_STATES):
        raise ValueError(
            f"selective_scan_bwd: unsupported operands x{tuple(x.shape)} "
            f"b{tuple(b.shape)} a{tuple(a.shape)} "
            f"h_starts{tuple(h_starts.shape)} (all f32; N one of "
            f"{KERNEL_STATES})")
    compat.require_cuda(*ops)
    f32 = torch.float32
    dx = torch.empty((bt, s, di), dtype=f32, device=x.device)
    ddt = torch.empty_like(dx)
    n_blk = -(-di // BWD_CHANNELS)
    db_part = torch.empty((bt, s, n_blk, n), dtype=f32, device=x.device)
    dc_part = torch.empty_like(db_part)
    da_part = torch.empty((bt, di, n), dtype=f32, device=x.device)
    starts = torch.empty(bwd_scratch_floats(bt, di, n, chunk), dtype=f32,
                         device=x.device)
    if x.device.type == "meta":
        compat.on_meta(bwd_counter, bt=bt, s=s, di=di, n=n, chunk=chunk)
        return (dx, ddt, db_part.sum(dim=2), dc_part.sum(dim=2),
                da_part.sum(dim=0))
    lib = compat.load("selective_scan_bwd",
                      {"selective_scan_bwd_launch": _BWD_SIG})
    err = lib.selective_scan_bwd_launch(
        *(t.data_ptr() for t in ops), dx.data_ptr(), ddt.data_ptr(),
        db_part.data_ptr(), dc_part.data_ptr(), da_part.data_ptr(),
        starts.data_ptr(), bt, s, di, n, chunk, compat.stream_ptr(x))
    bwd_counter.bump()
    compat.check(err, "selective_scan_bwd")
    return dx, ddt, db_part.sum(dim=2), dc_part.sum(dim=2), da_part.sum(dim=0)


class SelectiveScan(torch.autograd.Function):
    """The reference's ``selective_scan_trainable`` custom VJP: K6 forward,
    keeping its ``h_starts`` (``_sst_fwd``); K9 backward on f32 operands,
    each gradient cast back to its input's dtype, the gradient into h0 zero
    (``_sst_bwd``)."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a, h0, chunk, bd):
        y, _, h_starts = selective_scan(x, dt, b, c, a, h0, chunk=chunk,
                                        bd=bd)
        ctx.save_for_backward(x, dt, b, c, a, h0, h_starts)
        ctx.chunk, ctx.bd = chunk, bd
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, b, c, a, h0, h_starts = ctx.saved_tensors
        f32 = torch.float32
        dx, ddt, db, dc, da = selective_scan_bwd(
            x.to(f32), dt.to(f32), b.to(f32), c.to(f32), a.to(f32),
            h_starts, dy.to(f32).contiguous(), chunk=ctx.chunk, bd=ctx.bd)
        return (dx.to(x.dtype), ddt.to(dt.dtype), db.to(b.dtype),
                dc.to(c.dtype), da.to(a.dtype), torch.zeros_like(h0), None,
                None)


def selective_scan_trainable(x: Tensor, dt: Tensor, b: Tensor, c: Tensor,
                             a: Tensor, h0: Tensor, chunk: int = 128,
                             bd: int = 512) -> Tensor:
    """Differentiable fused scan: y only (the train path does not expose
    h_final), K6 forward and K9 backward."""
    return SelectiveScan.apply(x, dt, b, c, a, h0, chunk, bd)
