#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, in order; any failure exits non-zero and prints no result line:

1. Print the card's name and power limit (``nvidia-smi``), then build every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all started together) and print the build time.
2. Hold each kernel against its plain PyTorch version at the main paths'
   shapes: the GEMMs K1-K3 at M in {4, 512} x (K, N) in {(2304, 2304),
   (2304, 5760), (5760, 2304), (2304, 122753)}, in bf16 (beta unfolded) and
   int8 (beta folded, as the int8 dense layer calls them); the flash kernel
   K4 at BH = 4 x 36, d = 64, causal, over the prefill buckets S in {16, 32,
   64, 128}; the paged kernel K5 at decode (B 4, H = KV = 36, Sq 1 and 4,
   d 64, pages of 16, 16 pages a sequence, lengths 17-256 and one of 0), a
   64-row prefill chunk, GQA group 4, a window of 40 and an MLA-like d 576,
   dv 512, in bf16 and f32; the fused conv K7 at seven ResNet-50 / AlexNet
   convs at batch 8 (CONV_CASES), baseline, FIP and FFIP, f32 and int8
   (beta folded). Tolerances: int8 exact; bf16 and f32 GEMMs and K7 the
   reference's f32 GEMM bar (rtol 1e-4, atol 1e-3 * max(1, K // 64)), both
   sides summing the same products in f32 in another order; flash o at 2**-7
   (one bf16 rounding of o) and lse at 2e-3; K5 at 2**-7, with exact zeros
   for a sequence of length 0. Each call is timed with CUDA events, L2
   flushed between launches, beside its plain version (timed on the call
   that checks it, after a warm call for the cheap K4/K5 ones), its library
   yardstick and its bound.
3. Batch invariance, bit for bit: rows 0-3 of an M = 512 K1/K2/K3 call
   against the same rows at M = 4, 64 and 256 (f32 and bf16), and image 0
   of a batch-8 K7 call against the batch-1 call.
4. Serve minicpm-2b at its published widths (random weights from --seed)
   through ``BatchServer(gemm_impl="cuda")``: 4 slots, 8 requests of 16-128
   prompt tokens, 16 new tokens each, once each with gemm_algo ffip, fip and
   baseline and once int8 (quantized, ffip). Launch counts are zeroed just
   before each run and read just after. Every request must complete with its
   exact budget.
5. Check the tokens against the plain path (torch.matmul / the plain int8
   algebra, plain attention, one prompt at a time): each served first token
   against a plain prefill of its prompt, each second token against a plain
   decode step fed the served first token. A token must be the plain argmax
   or within a bar of standard deviations of the plain logits' max
   (FLOAT_BAR_SD, INT8_BAR_SD). The int8 bar is held between readings
   taken in the same run: the int8 run once more with plain attention (no
   flash kernel; it must pass the float bar) and int8 runs with planted
   faults (each must fail the int8 bar).
6. Serve minicpm-2b paged (``paged=True``, K5 for all attention): 4 slots,
   max_len 256 in pages of 16, prefill chunks of 64, 8 prompts of 16-128
   tokens (the even ones behind a shared 64-token prefix, the last a copy of
   the first), 16 new tokens each: flash ffip at decode_chunk 4 and flash
   int8 at decode_chunk 1, their first and second tokens held to the plain
   path under the same bars. Then, at the first IDENTITY_LAYERS layers:
   int8 and float FFIP with every prompt in one chunk must give the tokens
   they give in chunks of 64, and gather-paged int8 with plain attention the
   contiguous server's tokens. Every paged run must hit the
   prefix index, copy on write, drain its page reservations, balance the
   allocator, peak below slots x max_pages pages, and launch K5 exactly
   n_layers x (prefill chunks + decode dispatches x decode_chunk) times and
   K4 never. K7 must never launch on the LM paths.
7. The CNN path (VISION_RUNS): ResNet-50 (224) in float ffip, fip and
   baseline and int8 ffip, AlexNet (227) in float ffip and int8 ffip, batch
   8, published widths, 1000 classes, f32 weights from --seed, through
   ``repro_torch.vision`` with ``GemmConfig(impl="cuda")``. Each forward
   must launch K7 once per conv (53 / 5) and its FC kernel once per FC
   (1 / 3) and nothing else; float logits within a relative L2 error of
   1e-3 of the plain path's (F.conv2d with TF32 off, torch.matmul), or for
   FIP/FFIP, where the plain path's own FIP/FFIP algebra misses that, no
   further off than it; int8 logits equal to the plain int8 path's bit for
   bit and within 0.35 of the plain float logits.
8. Count and profile one contiguous prefill dispatch and decode step, one
   paged decode step, one paged prefill chunk and one ResNet-50 forward.
9. Print the kernels line (JSON), then the result line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# NVIDIA H100 SXM peaks (data sheet, dense) that bound each call: device
# memory, bf16 and int8 tensor cores, and the f32 CUDA cores where FIP/FFIP's
# pre-add (which has no tensor-core mapping) must run.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "cuda_core": 67e12}

GEMM_MS = (4, 512)
GEMM_KN = ((2304, 2304), (2304, 5760), (5760, 2304), (2304, 122753))
FLASH_SEQS = (16, 32, 64, 128)
HEADLINE_GEMM = (4, 2304, 5760, "bf16")     # decode up/gate projection
HEADLINE_FLASH_S = 128
# Token bars, in standard deviations of the plain-path logits. Float: bf16
# near-ties after 40 layers. int8: the per-token activation quantization
# turns bf16-level differences (flash vs plain attention) into whole int8
# steps. Its bar lies between the largest reading of a sound int8 run
# (0.098 sd seen on an H100; 0 with plain attention on both sides) and the
# smallest reading of a planted fault it must see (1.006 sd); each run
# prints both and fails if the bar no longer lies between them.
FLOAT_BAR_SD = 0.05
INT8_BAR_SD = 0.25
REPLACES = {
    "baseline_gemm": "src/repro/kernels/baseline_gemm.py:58",
    "fip_gemm": "src/repro/kernels/fip_gemm.py:65",
    "ffip_gemm_y": "src/repro/kernels/ffip_gemm.py:92",
    "flash_fwd": "src/repro/kernels/flash_attention.py:81",
    "flash_paged": "src/repro/kernels/flash_attention.py:335",
    "conv_gemm": "src/repro/kernels/conv_gemm.py:172",
}
SOURCES = {
    "baseline_gemm": "src/repro_torch/kernels/csrc/baseline_gemm.cu",
    "fip_gemm": "src/repro_torch/kernels/csrc/fip_gemm.cu",
    "ffip_gemm_y": "src/repro_torch/kernels/csrc/ffip_gemm.cu",
    "flash_fwd": "src/repro_torch/kernels/csrc/flash_fwd.cu",
    "flash_paged": "src/repro_torch/kernels/csrc/flash_paged.cu",
    "conv_gemm": "src/repro_torch/kernels/csrc/conv_gemm.cu",
}
# K7 checks at batch 8: (label, h, w, cin, cout, kh, kw, stride, pad,
# groups), ResNet-50's and AlexNet's convs at their published widths
CONV_BATCH = 8
CONV_CASES = (
    ("resnet50 conv1", 224, 224, 3, 64, 7, 7, 2, 3, 1),
    ("resnet50 s2b1.c2", 56, 56, 64, 64, 3, 3, 1, 1, 1),
    ("resnet50 s3b1.c1", 56, 56, 256, 128, 1, 1, 2, 0, 1),
    ("resnet50 s4b2.c2", 14, 14, 256, 256, 3, 3, 1, 1, 1),
    ("resnet50 s5b3.c3", 7, 7, 512, 2048, 1, 1, 1, 0, 1),
    ("alexnet conv1", 227, 227, 3, 96, 11, 11, 4, 0, 1),
    ("alexnet conv2", 27, 27, 96, 256, 5, 5, 1, 2, 2),
)
HEADLINE_CONV = ("resnet50 s2b1.c2", "f32", "ffip")
# The vision runs: (model, image size, [(label, algo, quantized)]), batch 8,
# published widths, 1000 classes, f32 weights from --seed
VISION_RUNS = (
    ("resnet50", 224, (("ffip", "ffip", False), ("fip", "fip", False),
                       ("baseline", "baseline", False),
                       ("int8-ffip", "ffip", True))),
    ("alexnet", 227, (("ffip", "ffip", False), ("int8-ffip", "ffip", True))),
)
# Relative L2 error of the logits against the plain float path (the
# launcher's bars). A float FIP/FFIP run is held to the larger of 1e-3 and
# the error of the plain path in its own algebra (the reference's float
# FIP/FFIP, materialised): in f32 the pre-add (a + b) drops the low bits of
# b when |a| >> |b|, and the BN-free random ResNet-50 grows its activations
# block by block, so that algebra itself misses 1e-3 there.
VISION_FLOAT_BAR = 1e-3
VISION_INT8_BAR = 0.35
# K5 checks: (label, B, H, KV, Sq, d, dv, page size, max_pages, window,
# scale). Decode lengths are drawn from 17-256 with the first set to 0 (its
# rows must be exact zeros); the prefill chunk is a prompt's second 64-row
# chunk (q_start 64, lengths 128).
PAGED_CASES = (
    ("decode", 4, 36, 36, 1, 64, 64, 16, 16, 0, None),
    ("decode Sq 4", 4, 36, 36, 4, 64, 64, 16, 16, 0, None),
    ("prefill chunk", 1, 36, 36, 64, 64, 64, 16, 16, 0, None),
    ("GQA group 4", 4, 36, 9, 1, 64, 64, 16, 16, 0, None),
    ("window 40", 4, 36, 36, 4, 64, 64, 16, 16, 40, None),
    ("MLA-like", 4, 16, 1, 1, 576, 512, 16, 16, 0, 192 ** -0.5),
)
HEADLINE_PAGED = ("decode", "bf16")
# The paged workload: 4 slots, max_len 256 in pages of 16, prefill chunks of
# 64; 8 prompts of 16-128 tokens, the even ones behind a shared 64-token
# prefix, the last a copy of the first.
PAGED_SLOTS, PAGED_MAX_LEN, PAGE_SIZE, PREFILL_CHUNK = 4, 256, 16, 64
# Depth of the paged identity runs (chunk widths, gather vs contiguous): the
# first layers of the same weights, to keep the whole run short.
IDENTITY_LAYERS = 8

_flush_buf = None


def time_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, each between its own
    CUDA events, with the 50 MB L2 flushed (a 64 MiB write) before each, as
    the serving loop finds a layer's weights cold."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    if warm:
        fn()
    events = []
    for _ in range(reps):
        _flush_buf.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def timed(fn):
    """(fn's result, its device ms): one call between CUDA events, for the
    plain versions, whose checking call is also their timing."""
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def reps_for(ms: float) -> int:
    return max(3, min(20, int(300.0 / max(ms, 1e-3))))


def yardstick_ms(fn):
    """Time of the library call that computes the same function, or None
    where PyTorch has none for these operands (``torch._int_mm`` refuses
    some shapes)."""
    try:
        fn()
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"  (no library yardstick: {str(e).splitlines()[0]})")
        return None
    return time_ms(fn, 5)


def _err(got: torch.Tensor, want: torch.Tensor):
    d = (got.double() - want.double()).abs()
    return float(d.max()), float((d / want.double().abs().clamp_min(1e-6)).max())


def _allclose(got, want, rtol, atol) -> bool:
    return bool(((got.double() - want.double()).abs()
                 <= atol + rtol * want.double().abs()).all())


def gemm_bound(name: str, m: int, k: int, n: int, dtype: str):
    """(bound_ms, bound_by) of one GEMM call: each input read once (A, then
    B or, for FFIP, its f32/int32 deltas y), the f32/int32 output written
    once; baseline at the tensor-core peak of its type, FIP/FFIP
    (2 pre-adds, a multiply and an add per pair, + alpha and beta) at the
    CUDA-core peak."""
    elt = 2 if dtype == "bf16" else 1
    b_bytes = k * n * (4 if name == "ffip_gemm_y" else elt)
    nbytes = m * k * elt + b_bytes + m * n * 4
    if name == "baseline_gemm":
        ops, peak = 2.0 * m * n * k, PEAK_OPS_S[dtype]
    else:
        beta = 0 if dtype == "int8" else k * n
        ops, peak = 2.0 * m * n * k + m * k + beta, PEAK_OPS_S["cuda_core"]
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_gemms(dev):
    """K1-K3 against their plain versions at the main path's shapes."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.baseline_gemm import (baseline_gemm,
                                                   baseline_gemm_plain)
    from repro_torch.kernels.ffip_gemm import (ffip_gemm_y, ffip_gemm_y_plain,
                                               y_for)
    from repro_torch.kernels.fip_gemm import fip_gemm, fip_gemm_plain

    records = []
    g = torch.Generator(device=dev).manual_seed(0)
    for m in GEMM_MS:
        for k, n in GEMM_KN:
            # pairs per plain-version step: its (M, pairs, N) temporaries
            # stay near 64 MiB
            kc = max(1, min(16, (64 << 20) // (m * n * 4)))
            for dtype in ("bf16", "int8"):
                if dtype == "int8":
                    a = torch.randint(-128, 128, (m, k), generator=g,
                                      device=dev).to(torch.int8)
                    b = torch.randint(-128, 128, (k, n), generator=g,
                                      device=dev).to(torch.int8)
                    fold = True
                    lib = lambda: torch._int_mm(a, b)     # noqa: E731
                else:
                    a = torch.randn((m, k), generator=g, device=dev).to(
                        torch.bfloat16)
                    b = (torch.randn((k, n), generator=g, device=dev)
                         / k ** 0.5).to(torch.bfloat16)
                    fold = False
                    lib = lambda: torch.matmul(a, b)      # noqa: E731
                bm, bn, bk = ops.choose_blocks(m, n, k, "ffip")
                blk = dict(bm=bm, bn=bn, bk=bk)
                y = y_for(b)
                calls = {
                    "baseline_gemm": (
                        lambda: baseline_gemm(a, b, **blk),
                        lambda: baseline_gemm_plain(a, b, **blk)),
                    "fip_gemm": (
                        lambda: fip_gemm(a, b, fold_beta=fold, **blk),
                        lambda: fip_gemm_plain(a, b, fold_beta=fold,
                                               k_chunk=kc, **blk)),
                    "ffip_gemm_y": (
                        lambda: ffip_gemm_y(a, y, fold_beta=fold, **blk),
                        lambda: ffip_gemm_y_plain(a, y, fold_beta=fold,
                                                  k_chunk=kc, **blk)),
                }
                lib_ms = yardstick_ms(lib)
                for name, (kern, plain) in calls.items():
                    got = kern()
                    torch.cuda.synchronize()
                    want, plain_ms = timed(plain)
                    abs_err, rel_err = _err(got, want)
                    if dtype == "int8":
                        ok, tol = torch.equal(got, want), "exact"
                    else:
                        atol = 1e-3 * max(1, k // 64)
                        ok = _allclose(got, want, 1e-4, atol)
                        tol = f"rtol 1e-4 atol {atol:g}"
                    one = time_ms(kern, 1)
                    ms = time_ms(kern, reps_for(one), warm=False)
                    bound_ms, bound_by = gemm_bound(name, m, k, n, dtype)
                    rec = dict(kernel=name, m=m, k=k, n=n, dtype=dtype,
                               fold_beta=fold, ok=ok, max_abs_err=abs_err,
                               max_rel_err=rel_err, tol=tol, ms=ms,
                               plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bound_ms, bound_by=bound_by)
                    records.append(rec)
                    print(f"  {name:13s} M={m:<3d} K={k:<4d} N={n:<6d} "
                          f"{dtype:4s} {'ok ' if ok else 'BAD'} "
                          f"max_abs={abs_err:.3g} max_rel={rel_err:.3g} "
                          f"({tol})  {ms:.4f} ms  plain {plain_ms:.3f} ms  "
                          f"lib {lib_ms if lib_ms is None else round(lib_ms, 4)}"
                          f" ms  bound {bound_ms:.4f} ms ({bound_by})",
                          flush=True)
                    del got, want
                del a, b, y
    return records


def check_flash(dev):
    """K4 against its plain version over the prefill buckets."""
    from repro_torch.kernels.flash_attention import _flash_fwd, _flash_fwd_plain
    import torch.nn.functional as F

    records = []
    g = torch.Generator(device=dev).manual_seed(1)
    bh, d = 4 * 36, 64
    for s in FLASH_SEQS:
        q, k, v = (torch.randn((bh, s, d), generator=g, device=dev).to(
            torch.bfloat16) for _ in range(3))
        o, lse = _flash_fwd(q, k, v, 0, causal=True)
        torch.cuda.synchronize()
        plain = lambda: _flash_fwd_plain(q, k, v, 0, causal=True)  # noqa: E731
        plain()                                   # warm: first-use set-up
        (o_ref, lse_ref), plain_ms = timed(plain)
        o_err, _ = _err(o, o_ref)
        lse_err, _ = _err(lse, lse_ref)
        ok = (_allclose(o, o_ref, 2 ** -7, 2 ** -7)
              and _allclose(lse, lse_ref, 2e-3, 2e-3))
        kern = lambda: _flash_fwd(q, k, v, 0, causal=True)      # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(           # noqa: E731
            q[None], k[None], v[None], is_causal=True)
        ms = time_ms(kern, 20)
        lib_ms = time_ms(lib, 20)
        pairs = s * (s + 1) // 2                  # causal (q, k) pairs per head
        t_ops = 4.0 * bh * pairs * d / PEAK_OPS_S["bf16"] * 1e3
        t_bytes = (4 * bh * s * d * 2 + bh * s * 4) / HBM_BYTES_S * 1e3
        bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                              else (t_ops, "operations"))
        records.append(dict(kernel="flash_fwd", bh=bh, s=s, d=d, ok=ok,
                            max_abs_err=max(o_err, lse_err), ms=ms,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            tol="o 2**-7, lse 2e-3"))
        print(f"  flash_fwd     BH={bh} S={s:<3d} d={d} causal bf16 "
              f"{'ok ' if ok else 'BAD'} o_err={o_err:.3g} "
              f"lse_err={lse_err:.3g}  {ms:.4f} ms  plain {plain_ms:.3f} ms  "
              f"sdpa {lib_ms:.4f} ms  bound {bound_ms:.5f} ms ({bound_by})",
              flush=True)
    return records


def paged_bound(q, k_pool, v_pool, page_table, lengths, q_start, window):
    """(bound_ms, bound_by) of one K5 call on this call's data: bytes are the
    valid K/V rows (each read once), q, o, the table and the two length
    vectors; operations are 2 (d + dv) per kept (q, k) pair and head (the QK
    and PV products), at the peak for the input type (bf16 tensor cores, or
    the f32 CUDA cores)."""
    b, h, sq, d = q.shape
    _, ps, kv, _ = k_pool.shape
    dv = v_pool.shape[-1]
    elt = q.element_size()
    rows = torch.clamp(lengths.cpu(), max=page_table.shape[1] * ps)
    q_pos = q_start.cpu()[:, None, None] + torch.arange(sq)[None, :, None]
    k_pos = torch.arange(int(rows.max()))[None, None, :]
    kept = (k_pos < rows[:, None, None]) & (q_pos >= k_pos)
    if window > 0:
        kept &= (q_pos - k_pos) < window
    nbytes = (int(rows.sum()) * kv * (d + dv) * elt + b * h * sq * (d + dv)
              * elt + page_table.numel() * 4 + 2 * b * 4)
    ops = 2.0 * (d + dv) * h * int(kept.sum())
    peak = PEAK_OPS_S["bf16" if q.dtype == torch.bfloat16 else "cuda_core"]
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_paged(dev):
    """K5 against its plain version at the paged path's shapes, bf16 and
    f32, under K4's bar (2**-7); rows with no valid key must be exact
    zeros. The yardstick is the page gather (``_paged_view``) of K and V
    plus ``scaled_dot_product_attention`` under a boolean mask: PyTorch has
    no single call for paged attention."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_paged import (flash_attention_paged,
                                                 flash_attention_paged_plain)
    from repro_torch.models.attention import _paged_view

    records = []
    g = torch.Generator(device=dev).manual_seed(2)
    for (label, b, h, kv, sq, d, dv, ps, mp, window,
         scale) in PAGED_CASES:
        for dtype, dname in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            n_pages = b * mp
            q = torch.randn((b, h, sq, d), generator=g, device=dev).to(dtype)
            kp = torch.randn((n_pages, ps, kv, d), generator=g,
                             device=dev).to(dtype)
            vp = torch.randn((n_pages, ps, kv, dv), generator=g,
                             device=dev).to(dtype)
            pt = torch.randperm(n_pages, generator=g, device=dev).reshape(
                b, mp).to(torch.int32)
            if label == "prefill chunk":
                lengths = torch.full((b,), 128, device=dev)
                q_start = torch.full((b,), 64, device=dev)
            else:
                lengths = torch.randint(17, ps * mp + 1, (b,), generator=g,
                                        device=dev)
                lengths[0] = 0
                q_start = (lengths - sq).clamp_min(0)
            args = (q, kp, vp, pt, lengths, q_start, window)
            kern = lambda: flash_attention_paged(    # noqa: E731
                *args, scale=scale)
            plain = lambda: flash_attention_paged_plain(  # noqa: E731
                *args, scale=scale)
            o = kern()
            torch.cuda.synchronize()
            plain()                               # warm: first-use set-up
            want, plain_ms = timed(plain)
            abs_err, _ = _err(o, want)
            ok = _allclose(o, want, 2 ** -7, 2 ** -7)
            zeros = "n/a"
            if label != "prefill chunk":
                zeros = bool(torch.count_nonzero(o[0]) == 0)
                ok = ok and zeros
            k_pos = torch.arange(mp * ps, device=dev)
            q_pos = q_start[:, None] + torch.arange(sq, device=dev)
            diff = q_pos[:, :, None] - k_pos[None, None, :]
            mask = (k_pos[None, None, :] < lengths[:, None, None]) & (diff >= 0)
            if window > 0:
                mask &= diff < window
            mask = mask[:, None]
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, _paged_view(kp, pt).transpose(1, 2),
                _paged_view(vp, pt).transpose(1, 2), attn_mask=mask,
                scale=scale, enable_gqa=h != kv)
            ms = time_ms(kern, 20)
            lib_ms = yardstick_ms(lib)
            bound_ms, bound_by = paged_bound(*args)
            records.append(dict(
                kernel="flash_paged", case=label, dtype=dname, b=b, h=h, kv=kv,
                sq=sq, d=d, dv=dv, ps=ps, max_pages=mp, window=window, ok=ok,
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                tol="2**-7; rows with no valid key exactly 0"))
            print(f"  flash_paged   {label:13s} B={b} H={h} KV={kv} Sq={sq} "
                  f"d={d} dv={dv} w={window} {dname:4s} "
                  f"{'ok ' if ok else 'BAD'} max_abs={abs_err:.3g} zero rows "
                  f"{zeros}  {ms:.4f} ms  plain {plain_ms:.3f} ms  gather+sdpa "
                  f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms  "
                  f"bound {bound_ms:.5f} ms ({bound_by})", flush=True)
            del q, kp, vp, o, want
    return records


def conv_bound(algo: str, dtype: str, xp: torch.Tensor, stack: torch.Tensor,
               m: int, k: int):
    """(bound_ms, bound_by) of one K7 call: the padded input read once, the
    weights (FFIP: their f32/int32 deltas) and the f32/int32 output once;
    2 M N K operations (over all groups) at the CUDA-core peak (f32 without
    TF32, and every FIP/FFIP body), or the int8 peak for int8 baseline."""
    g, _, ng = stack.shape
    w_elt = 4 if algo == "ffip" else stack.element_size()
    nbytes = (xp.numel() * xp.element_size() + stack[:, :k].numel() * w_elt
              + m * g * ng * 4)
    peak = PEAK_OPS_S["int8" if (dtype, algo) == ("int8", "baseline")
                      else "cuda_core"]
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 2.0 * m * g * ng * k / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_convs(dev):
    """K7 against its plain version (A gathered through the Algorithm-1
    indices, then the plain K1/K2/K3 per group in K7's blocks) at ResNet-50's
    and AlexNet's conv shapes, batch 8; f32 at the GEMM bar, int8 exact
    (FIP and FFIP with beta folded, as the int8 conv calls them). The
    yardstick is F.conv2d in f32 with TF32 off; PyTorch has no CUDA int8
    convolution, so int8 has none."""
    import torch.nn.functional as F

    from repro_torch.kernels import conv_gemm as cg
    from repro_torch.kernels import ops

    records = []
    g = torch.Generator(device=dev).manual_seed(3)
    for label, h, w, cin, cout, kh, kw, st, pad, groups in CONV_CASES:
        geom = cg.ConvGeom(h=h + 2 * pad, w=w + 2 * pad, cin=cin, kh=kh,
                           kw=kw, sh=st, sw=st, groups=groups,
                           ng=cout // groups)
        m = CONV_BATCH * geom.m
        for dtype in ("f32", "int8"):
            if dtype == "int8":
                x = torch.randint(-128, 128, (CONV_BATCH, h, w, cin),
                                  generator=g, device=dev).to(torch.int8)
                kern = torch.randint(-128, 128, (kh, kw, cin // groups, cout),
                                     generator=g, device=dev).to(torch.int8)
                lib_ms = None
            else:
                x = torch.randn((CONV_BATCH, h, w, cin), generator=g,
                                device=dev)
                kern = torch.randn((kh, kw, cin // groups, cout), generator=g,
                                   device=dev) / geom.k ** 0.5
                lib_ms = yardstick_ms(lambda: F.conv2d(
                    x.permute(0, 3, 1, 2), kern.permute(3, 2, 0, 1),
                    stride=st, padding=pad, groups=groups))
            xp = F.pad(x, (0, 0, pad, pad, pad, pad))
            stack = cg._kernel_to_stack(kern, groups)
            bm, bn, bk = ops.choose_blocks(m, geom.ng, geom.k, "ffip")
            for algo in ("baseline", "fip", "ffip"):
                fold = dtype == "int8" and algo != "baseline"
                bg = {"baseline": stack, "fip": cg._evenize_k(stack),
                      "ffip": cg._y_even(stack)}[algo]
                kern_fn = lambda: cg.fused_conv_raw(   # noqa: E731
                    xp, stack, kh=kh, kw=kw, stride=st, groups=groups,
                    algo=algo, fold_beta=fold)
                got = kern_fn()
                torch.cuda.synchronize()
                want, plain_ms = timed(lambda: cg.fused_conv_plain(
                    xp, bg, geom, algo=algo, bm=bm, bn=bn, bk=bk,
                    fold_beta=fold))
                abs_err, rel_err = _err(got, want)
                if dtype == "int8":
                    ok, tol = torch.equal(got, want), "exact"
                else:
                    atol = 1e-3 * max(1, geom.k // 64)
                    ok = _allclose(got, want, 1e-4, atol)
                    tol = f"rtol 1e-4 atol {atol:g}"
                one = time_ms(kern_fn, 1)
                ms = time_ms(kern_fn, reps_for(one), warm=False)
                bound_ms, bound_by = conv_bound(algo, dtype, xp, bg, m,
                                                geom.k)
                records.append(dict(
                    kernel="conv_gemm", case=label, algo=algo, dtype=dtype,
                    batch=CONV_BATCH, m=m, k=geom.k, n=cout, groups=groups,
                    fold_beta=fold, ok=ok, max_abs_err=abs_err,
                    max_rel_err=rel_err, tol=tol, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by))
                lib = ("none (no CUDA int8 conv)" if lib_ms is None
                       else f"{lib_ms:.4f} ms")
                print(f"  conv_gemm     {label:17s} M={m:<6d} K={geom.k:<4d} "
                      f"N={cout:<4d} g{groups} {algo:8s} {dtype:4s} "
                      f"{'ok ' if ok else 'BAD'} max_abs={abs_err:.3g} "
                      f"({tol})  {ms:.4f} ms  plain {plain_ms:.3f} ms  "
                      f"conv2d {lib}  bound {bound_ms:.4f} ms ({bound_by})",
                      flush=True)
                del got, want
            del x, kern, xp, stack
    return records


def check_batch_invariance(dev):
    """Bit for bit: rows 0-3 of an M = 512 K1/K2/K3 call against the same
    rows at M = 4, 64 and 256 (f32 and bf16, at the served (K, N) pairs),
    and image 0 of a batch-8 K7 call against the batch-1 call (f32, the
    three algos, ResNet-50's s2b1.c2). Returns the failures."""
    from repro_torch.kernels import conv_gemm as cg
    from repro_torch.kernels import ops
    from repro_torch.kernels.baseline_gemm import baseline_gemm
    from repro_torch.kernels.ffip_gemm import ffip_gemm_y, y_for
    from repro_torch.kernels.fip_gemm import fip_gemm

    bad = []
    g = torch.Generator(device=dev).manual_seed(7)
    for k, n in ((2304, 5760), (5760, 2304)):
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn((512, k), generator=g, device=dev).to(dtype)
            b = (torch.randn((k, n), generator=g, device=dev)
                 / k ** 0.5).to(dtype)
            y = y_for(b)

            def blk(rows):
                return dict(zip(("bm", "bn", "bk"),
                                ops.choose_blocks(rows, n, k, "ffip")))
            fns = {"baseline_gemm": lambda a_: baseline_gemm(
                       a_, b, **blk(len(a_))),
                   "fip_gemm": lambda a_: fip_gemm(a_, b, **blk(len(a_))),
                   "ffip_gemm_y": lambda a_: ffip_gemm_y(
                       a_, y, **blk(len(a_)))}
            for name, fn in fns.items():
                full = fn(a)[:4]
                same = {m: torch.equal(fn(a[:m].contiguous())[:4], full)
                        for m in (4, 64, 256)}
                print(f"  batch invariance {name:13s} K={k} N={n} "
                      f"{str(dtype)[6:]:8s} rows 0-3 at M=512 vs M=4/64/256: "
                      f"{'identical' if all(same.values()) else same}",
                      flush=True)
                if not all(same.values()):
                    bad.append(f"{name} K={k} N={n} {dtype}: {same}")
            del a, b, y
    label, h, w, cin, cout, kh, kw, st, pad, groups = CONV_CASES[1]
    x = torch.randn((CONV_BATCH, h, w, cin), generator=g, device=dev)
    kern = torch.randn((kh, kw, cin, cout), generator=g, device=dev) / 24.0
    for algo in ("baseline", "fip", "ffip"):
        full = cg.conv_gemm_fused(x, kern, stride=st, pad=pad, algo=algo)
        one = cg.conv_gemm_fused(x[:1].contiguous(), kern, stride=st,
                                 pad=pad, algo=algo)
        same = torch.equal(full[:1], one)
        print(f"  batch invariance conv_gemm     {label} {algo:8s} f32 image 0 "
              f"of batch {CONV_BATCH} vs batch 1: "
              f"{'identical' if same else 'DIFFER'}", flush=True)
        if not same:
            bad.append(f"conv_gemm {label} {algo}: image 0 differs")
    return bad


class PlainPath:
    """The plain path on one prompt set: torch.matmul (float) or the plain
    int8 algebra, and plain attention, one prompt at a time. It keeps each
    prompt's prefill logits and cache, so that a decode step fed a served
    first token gives the plain logits of the served second token."""

    def __init__(self, model, params, prompts, quantized: bool):
        from repro_torch.core.gemm import GemmConfig
        from repro_torch.core.quant import attach_quantized_weights
        from repro_torch.models.model import Model

        self.model = Model(dataclasses.replace(model.cfg,
                                               attention_impl="naive"),
                           device=model.device)
        self.gemm = (GemmConfig(algo="ffip", impl="torch", quantized=True,
                                k_chunk=64)
                     if quantized else GemmConfig(algo="baseline",
                                                  impl="torch"))
        self.params = (attach_quantized_weights(params) if quantized
                       else params)
        self.lens = [len(p) for p in prompts]
        self.first, self.caches = [], []
        self._second = {}
        with self._scope():
            for prompt in prompts:
                tok = torch.as_tensor(prompt, device=model.device)[None]
                cache, logits = self.model.prefill(
                    self.params, tok, self.model.init_cache(1, len(prompt) + 1))
                self.first.append(logits[0].float())
                self.caches.append(cache)

    def _scope(self):
        import contextlib

        from repro_torch.core.gemm import use_gemm
        stack = contextlib.ExitStack()
        stack.enter_context(use_gemm(self.gemm))
        stack.enter_context(torch.no_grad())
        return stack

    def second(self, rid: int, first_tok: int) -> torch.Tensor:
        """Plain logits after the prompt and ``first_tok`` (its K/V row is
        the cache's last, rewritten by each call), kept per (request,
        token): the served runs mostly agree on first tokens."""
        key = (rid, first_tok)
        if key not in self._second:
            tok = torch.tensor([[first_tok]], device=self.model.device)
            with self._scope():
                _, logits = self.model.decode_step(self.params, tok,
                                                   self.caches[rid],
                                                   self.lens[rid])
            self._second[key] = logits[0].float()
        return self._second[key]


def kernel_deviation(model, params, prompts, plain: PlainPath,
                     algo: str):
    """Per prompt, max |logit| difference between a prefill through the
    kernels (the prompt alone) and the plain path, in standard deviations
    of the plain logits: the noise a float token reading sits in."""
    from repro_torch.core.gemm import GemmConfig, use_gemm
    from repro_torch.kernels import compat

    out = []
    with use_gemm(GemmConfig(algo=algo, impl="cuda")), torch.no_grad(), \
            compat.use_derived(compat.DerivedCache()):
        for i, prompt in enumerate(prompts):
            tok = torch.as_tensor(prompt, device=model.device)[None]
            _, logits = model.prefill(params, tok,
                                      model.init_cache(1, len(prompt) + 1))
            ref = plain.first[i]
            out.append(float((logits[0].float() - ref).abs().max()
                             / ref.std()))
    return out


def shortfall(logits: torch.Tensor, tok: int) -> float:
    """How far below the plain logits' max the served token's plain logit
    is, in standard deviations of those logits (0 when it is the argmax)."""
    return float((logits.max() - logits[tok]) / logits.std())


def token_readings(done, plain: PlainPath):
    """(first tokens equal to the plain argmax, worst first-token shortfall,
    worst second-token shortfall, with the plain decode step fed the served
    first token)."""
    exact, first, second = 0, 0.0, 0.0
    for r in done:
        lg = plain.first[r.rid]
        exact += int(r.out_tokens[0] == int(lg.argmax()))
        first = max(first, shortfall(lg, r.out_tokens[0]))
        second = max(second, shortfall(plain.second(r.rid, r.out_tokens[0]),
                                       r.out_tokens[1]))
    return exact, first, second


def planted_faults(params, n_layers: int):
    """Served-side copies of ``params``, each with one known fault, to show
    what the int8 token check can see: ``{label: (params, must_see)}``. The
    reference keeps the sound weights. A wrong layer's weights must fail the
    int8 bar. One int8 step more in every weight of a projection is below
    what any token check resolves (its readings fall among the sound ones):
    those are printed, not gated; the exact int8 kernel checks and the
    bit-exact CPU tests stand for that size of fault."""
    lay = params["layers"]

    def swap_leaf(group: str, name: str, leaf):
        out = dict(params)
        out["layers"] = dict(lay)
        out["layers"][group] = dict(lay[group])
        out["layers"][group][name] = dict(lay[group][name], w=leaf)
        return out

    def one_step_high(w, layers):
        """Each weight of the given layers one int8 quantization step (its
        column's range / 255) higher."""
        out = w.clone()
        sel = w[layers].float()
        step = (sel.amax(-2, keepdim=True) - sel.amin(-2, keepdim=True)) / 255
        out[layers] = (sel + step).to(w.dtype)
        return out

    down = lay["ffn"]["down"]["w"]
    wo = lay["attn"]["wo"]["w"]
    mid = (n_layers - 1) // 2
    wrong_layer = wo.clone()
    wrong_layer[mid] = wo[mid + 1]
    return {
        f"ffn.down of layer {n_layers - 1} one int8 step high": (
            swap_leaf("ffn", "down", one_step_high(down, slice(-1, None))),
            False),
        "ffn.down of every layer one int8 step high": (
            swap_leaf("ffn", "down", one_step_high(down, slice(None))),
            False),
        f"attn.wo of layer {mid} taken from layer {mid + 1}": (
            swap_leaf("attn", "wo", wrong_layer), True),
    }


def drive_main_path(model, params, prompts, max_new: int):
    """The served runs; launch counts zeroed before and read after each."""
    from repro_torch.kernels import compat
    from repro_torch.launch.serve import serve

    runs = []
    for algo, quantized in (("ffip", False), ("fip", False),
                            ("baseline", False), ("ffip", True)):
        label = ("int8-" if quantized else "") + algo
        torch.cuda.reset_peak_memory_stats()
        compat.reset_counters()
        srv, done, wall = serve(model, params, prompts, max_new=max_new,
                                batch_slots=4, max_len=256,
                                quantized=quantized, gemm_algo=algo,
                                gemm_impl="cuda")
        counts = compat.launch_counts()
        st = dict(srv.stats)
        tokens = sum(len(r.out_tokens) for r in done)
        budget_ok = (len(done) == len(prompts)
                     and all(len(r.out_tokens) == max_new for r in done))
        busy = st["prefill_s"] + st["decode_s"]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  [{label}] {len(done)}/{len(prompts)} requests, {tokens} "
              f"tokens, exact budgets {budget_ok}; wall {wall:.3f} s "
              f"(incl. one-time weight preparation); prefill "
              f"{st['prefill_s']:.3f} s ({st['prefill_tokens']} tok / "
              f"{st['prefill_dispatches']} dispatches), decode "
              f"{st['decode_s']:.3f} s ({st['decode_tokens']} tok / "
              f"{st['steps']} steps); {tokens / busy:.1f} tok/s over "
              f"prefill+decode; peak memory {peak:.2f} GiB; launches "
              f"{counts}", flush=True)
        runs.append(dict(label=label, algo=algo, quantized=quantized,
                         done=done, counts=counts, stats=st, wall_s=wall,
                         budget_ok=budget_ok, peak_gib=peak))
        del srv
    return runs


KERNEL_GROUPS = (("ConvA", "conv_gemm"),
                 ("ffip_kernel", "ffip_gemm_y"), ("fip_kernel", "fip_gemm"),
                 ("baseline_kernel", "baseline_gemm"),
                 ("reduce_units", "split-K reduce"),
                 ("flash_fwd_kernel", "flash_fwd"),
                 ("flash_paged_kernel", "flash_paged"))


def _group(kernel_name: str) -> str:
    for key, group in KERNEL_GROUPS:
        if key in kernel_name:
            return group
    return "torch ops"


def profile(steps):
    """Each of ``steps`` (name -> callable) under FFIP through the kernels,
    once to warm up and once profiled: launches counted, host wall time, and
    device time by kernel from ``torch.profiler`` (busy = the sum of kernel
    times; "not measured" where the profiler saw no device activity)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from repro_torch.core.gemm import GemmConfig, use_gemm
    from repro_torch.kernels import compat

    out = {}
    with use_gemm(GemmConfig(algo="ffip", impl="cuda")), torch.no_grad(), \
            compat.use_derived(compat.DerivedCache()):
        for phase, fn in steps.items():
            fn()
            torch.cuda.synchronize()
            compat.reset_counters()
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            launches = compat.launch_counts()
            device_ms: dict = {}
            for ev in prof.key_averages():
                us = getattr(ev, "self_device_time_total", 0) or 0
                if us > 0:
                    g = _group(ev.key)
                    device_ms[g] = device_ms.get(g, 0.0) + us / 1e3
            busy = sum(device_ms.values()) if device_ms else "not measured"
            out[phase] = dict(wall_ms=wall_ms, launches=launches,
                              device_ms=dict(sorted(
                                  device_ms.items(), key=lambda kv: -kv[1])),
                              busy_ms=busy)
    return out


def contiguous_steps(model, params, prompt_len: int):
    """One bucketed prefill dispatch (4 slots x ``prompt_len``) and one
    decode step over the contiguous cache."""
    dev = model.device
    cache = model.init_cache(4, 256)
    tokens = torch.zeros((4, prompt_len), dtype=torch.long, device=dev)
    lengths = torch.full((4,), prompt_len, dtype=torch.long, device=dev)
    mask = torch.ones((4,), dtype=torch.bool, device=dev)
    pos = torch.full((4,), prompt_len, dtype=torch.long, device=dev)
    return {
        "prefill": lambda: model.prefill_sample(params, tokens, cache,
                                                lengths, mask),
        "decode_step": lambda: model.sample_step(params, tokens[:, :1],
                                                 cache, pos),
    }


def paged_steps(model, params):
    """One paged decode step (4 slots at 128 cached rows) and one 64-row
    prefill chunk (a prompt's second) through K5 over the paged pool."""
    dev = model.device
    mp = PAGED_MAX_LEN // PAGE_SIZE
    cache = model.init_paged_cache(PAGED_SLOTS * mp, PAGE_SIZE)
    table = torch.arange(PAGED_SLOTS * mp, dtype=torch.int32,
                         device=dev).reshape(PAGED_SLOTS, mp)
    tok = torch.zeros((PAGED_SLOTS, 1), dtype=torch.long, device=dev)
    pos = torch.full((PAGED_SLOTS,), 128, dtype=torch.long, device=dev)
    chunk = torch.zeros((1, PREFILL_CHUNK), dtype=torch.long, device=dev)
    return {
        "paged decode_step": lambda: model.sample_step(
            params, tok, cache, pos, page_table=table, paged_impl="flash"),
        "paged prefill chunk": lambda: model.prefill_chunk_paged(
            params, chunk, cache, table[:1], PREFILL_CHUNK, PREFILL_CHUNK,
            PREFILL_CHUNK, paged_impl="flash"),
    }


def _first_layers(tree, n: int):
    """The first ``n`` layers of a stacked parameter tree, as views."""
    if isinstance(tree, dict):
        return {k: _first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def _same(a: dict, b: dict) -> str:
    """'identical', or the requests whose tokens differ and where first."""
    diff = {rid: next((i for i, (x, y) in enumerate(zip(toks, other))
                       if x != y), min(len(toks), len(other)))
            for rid, toks in a["tokens"].items()
            for other in [b["tokens"].get(rid, [])] if toks != other}
    return "identical" if not diff else f"differ (request: first index) {diff}"


def serve_paged(model, params, prompts, max_new: int, label: str, **kw):
    """One paged serve of ``prompts`` (launch counts zeroed just before and
    read just after) and the page-ledger checks every paged run must pass.
    Returns (record, problems)."""
    from repro_torch.kernels import compat
    from repro_torch.launch.serve import serve

    torch.cuda.reset_peak_memory_stats()
    compat.reset_counters()
    srv, done, wall = serve(model, params, prompts, max_new=max_new,
                            batch_slots=PAGED_SLOTS, max_len=PAGED_MAX_LEN,
                            gemm_impl="cuda", paged=True,
                            page_size=PAGE_SIZE, **kw)
    counts = compat.launch_counts()
    st = dict(srv.stats)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_layers = model.cfg.n_layers
    ledger = dict(reserved=srv._reserved, free=srv.alloc.free_count,
                  in_use=srv.alloc.in_use, num_pages=srv.alloc.num_pages,
                  contiguous_pages=srv.b * srv.max_pages)
    problems = []
    if (len(done) != len(prompts)
            or any(len(r.out_tokens) != max_new for r in done)):
        problems.append(f"{label}: a request missed its token budget")
    if st["prefix_hit_tokens"] <= 0 or st["cow_copies"] < 1:
        problems.append(f"{label}: no prefix hit or no copy on write")
    if ledger["reserved"] or ledger["free"] + ledger["in_use"] != \
            ledger["num_pages"]:
        problems.append(f"{label}: the page ledger does not balance {ledger}")
    if st["pages_peak"] >= ledger["contiguous_pages"]:
        problems.append(f"{label}: pages_peak {st['pages_peak']} not below "
                        f"slots x max_pages")
    want_k5 = 0
    if srv.paged_attention == "flash":
        want_k5 = n_layers * (st["prefill_chunks"]
                              + st["decode_dispatches"] * srv.decode_chunk)
    if counts["flash_paged"] != want_k5 or counts["flash_fwd"] != 0:
        problems.append(f"{label}: flash_paged launched "
                        f"{counts['flash_paged']} times (want {want_k5}), "
                        f"flash_fwd {counts['flash_fwd']} (want 0)")
    steps_ms = 1e3 * st["decode_s"] / max(1, st["steps"])
    print(f"  [{label}] {len(done)}/{len(prompts)} requests; prefill "
          f"{st['prefill_s']:.3f} s ({st['prefill_tokens']} tok / "
          f"{st['prefill_chunks']} chunks), decode {st['decode_s']:.3f} s "
          f"({st['decode_tokens']} tok / {st['steps']} steps / "
          f"{st['decode_dispatches']} dispatches, {steps_ms:.1f} ms/step); "
          f"peak memory {peak:.2f} GiB; pages_peak {st['pages_peak']} of "
          f"{ledger['num_pages']} (contiguous equivalent "
          f"{ledger['contiguous_pages']}), prefix_hit_tokens "
          f"{st['prefix_hit_tokens']}, cow_copies {st['cow_copies']}; "
          f"ledger {ledger}; launches {counts}", flush=True)
    rec = dict(label=label, done=done, counts=counts, stats=st, wall_s=wall,
               peak_gib=peak, ms_per_step=steps_ms,
               tokens={r.rid: list(r.out_tokens) for r in done})
    del srv
    return rec, problems


def run_vision(dev, seed: int):
    """ResNet-50 and AlexNet at their published widths, batch 8, through
    ``repro_torch.vision`` with ``GemmConfig(impl="cuda")`` (every conv
    through K7, the FCs through K1-K3), each forward's launch counts zeroed
    before and read after, against the plain path (F.conv2d with TF32 off
    and torch.matmul for float; the materialising int8 reference and the
    plain int8 dense for int8; the materialised FIP/FFIP algebra for the
    bar of a float FIP/FFIP run). Returns (records, problems)."""
    from repro_torch.core.gemm import GemmConfig, use_gemm
    from repro_torch.kernels import compat
    from repro_torch.launch.vision import rel_err
    from repro_torch.vision import models as vm

    fc_kernel = {"ffip": "ffip_gemm_y", "fip": "fip_gemm",
                 "baseline": "baseline_gemm"}
    records, problems = [], []
    for name, size, runs in VISION_RUNS:
        model = vm.build(name, num_classes=1000, image_size=size)
        n_convs = len(vm.conv_layers(model))
        n_fcs = sum(isinstance(layer, vm.FC) for layer in model)
        params = vm.init_params(model, seed, device=dev)
        qparams = vm.attach_quantized(model, params)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        x = torch.randn((CONV_BATCH, size, size, 3), generator=gen,
                        device=dev)

        def forward(cfg, p):
            """(logits, host wall ms, device ms, peak GiB, launches)."""
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            compat.reset_counters()
            s_ev = torch.cuda.Event(enable_timing=True)
            e_ev = torch.cuda.Event(enable_timing=True)
            with use_gemm(cfg), torch.no_grad():
                t0 = time.perf_counter()
                s_ev.record()
                out = vm.apply(model, p, x)
                e_ev.record()
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counts = {k: v for k, v in compat.launch_counts().items() if v}
            return (out, wall, s_ev.elapsed_time(e_ev),
                    torch.cuda.max_memory_allocated() / 2 ** 30, counts)

        plain_cfgs = {"float": GemmConfig(algo="baseline", impl="torch"),
                      "int8": GemmConfig(algo="ffip", impl="torch",
                                         quantized=True, k_chunk=16)}
        plain_cfgs.update({algo: GemmConfig(algo=algo, impl="torch")
                           for _, algo, q in runs
                           if not q and algo != "baseline"})
        plain = {key: forward(cfg, qparams if key == "int8" else params)[0]
                 for key, cfg in plain_cfgs.items()}
        float_ref = plain["float"]
        algebra_err = {key: rel_err(out, float_ref)
                       for key, out in plain.items() if key in ("fip", "ffip")}
        print(f"  [{name} plain] top1 {float_ref.argmax(-1).tolist()}; "
              f"max |logit| {float(float_ref.abs().max()):.4g}; the plain "
              f"FIP/FFIP algebra's own rel_err vs plain float "
              f"{ {k: round(v, 6) for k, v in algebra_err.items()} }",
              flush=True)
        for label, algo, quantized in runs:
            cfg = GemmConfig(algo=algo, impl="cuda", quantized=quantized)
            p = qparams if quantized else params
            forward(cfg, p)                          # warm: first-use set-up
            out, wall, dev_ms, peak, counts = forward(cfg, p)
            err = rel_err(out, float_ref)
            want = {"conv_gemm": n_convs, fc_kernel[algo]: n_fcs}
            got = {k: counts.get(k, 0) for k in want}
            other = {k: v for k, v in counts.items() if k not in want}
            line = (f"  [{name} {label}] wall {wall:.1f} ms, device "
                    f"{dev_ms:.1f} ms, peak {peak:.2f} GiB, top1 "
                    f"{out.argmax(-1).tolist()}, rel_err vs plain float "
                    f"{err:.3g}")
            if quantized:
                same = torch.equal(out, plain["int8"])
                line += f", logits = plain int8: {same}"
                if not same:
                    problems.append(f"{name} {label}: logits differ from the "
                                    f"plain int8 path")
            bar = (VISION_INT8_BAR if quantized
                   else max(VISION_FLOAT_BAR, algebra_err.get(algo, 0.0)))
            line += f" (bar {bar:.4g})"
            if not (bool(torch.isfinite(out).all()) and err <= bar):
                problems.append(f"{name} {label}: rel_err {err:.3g} > {bar} "
                                f"(or logits not finite)")
            if got != want or other:
                problems.append(f"{name} {label}: launches {counts}, want "
                                f"{want} and nothing else")
            print(f"{line}; launches {counts}", flush=True)
            records.append(dict(model=name, label=label, wall_ms=wall,
                                device_ms=dev_ms, peak_gib=peak,
                                rel_err=err, bar=bar, counts=counts,
                                top1=out.argmax(-1).tolist()))
        del params, qparams, plain, float_ref
        torch.cuda.empty_cache()
    return records, problems


def vision_step(dev, seed: int):
    """One ResNet-50 forward at batch 8, for the profile."""
    from repro_torch.vision import models as vm

    model = vm.build("resnet50", num_classes=1000, image_size=224)
    params = vm.init_params(model, seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((CONV_BATCH, 224, 224, 3), generator=gen, device=dev)
    return lambda: vm.apply(model, params, x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=40,
                    help="depth of minicpm-2b (published: 40); widths stay")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this smoke run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.kernels import compat
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models.model import Model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build
    build_s = compat.build_all()
    print(f"phase build: {len(compat.build_log)} kernel sources compiled "
          f"for sm_90a in {build_s:.1f} s (parallel nvcc)", flush=True)

    # 2. kernels against their plain versions
    t0 = time.perf_counter()
    print("phase kernels: hand-written kernel vs plain version", flush=True)
    gemm_recs = check_gemms(dev)
    flash_recs = check_flash(dev)
    paged_recs = check_paged(dev)
    conv_recs = check_convs(dev)
    recs = gemm_recs + flash_recs + paged_recs + conv_recs
    bad = [r for r in recs if not r["ok"]]
    print(f"phase kernels: {len(recs)} checks, {len(bad)} failed, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if bad:
        print(f"FAIL: kernels disagree with their plain versions: {bad}",
              file=sys.stderr)
        return 1
    compat.derived.clear()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    print("phase invariance: a row's bits must not depend on the rows "
          "beside it", flush=True)
    varying = check_batch_invariance(dev)
    print(f"phase invariance: {time.perf_counter() - t0:.1f} s", flush=True)
    if varying:
        print(f"FAIL: results depend on the batch: {varying}",
              file=sys.stderr)
        return 1
    compat.derived.clear()
    torch.cuda.empty_cache()

    # 3. the main path: minicpm-2b served at full width, contiguous cache
    t0 = time.perf_counter()
    full = configs.get_config("minicpm-2b")
    cfg = dataclasses.replace(full, n_layers=args.layers)
    print(f"phase serve: {cfg.name} d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}x{cfg.hd} (kv {cfg.n_kv_heads}), d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.param_dtype}; n_layers {cfg.n_layers} "
          f"(published {full.n_layers})", flush=True)
    model = Model(cfg)
    params = model.init(args.seed)
    naive = Model(dataclasses.replace(cfg, attention_impl="naive"))
    prompts = make_prompts(cfg.vocab, 8, np.random.default_rng(args.seed),
                           16, 129)
    runs = drive_main_path(model, params, prompts, args.max_new)
    expect = {"ffip": "ffip_gemm_y", "fip": "fip_gemm",
              "baseline": "baseline_gemm"}
    problems = [f"{r['label']}: {expect[r['algo']]} never launched"
                for r in runs if r["counts"][expect[r["algo"]]] == 0]
    problems += [f"{r['label']}: a request missed its token budget"
                 for r in runs if not r["budget_ok"]]
    print(f"phase serve: {time.perf_counter() - t0:.1f} s", flush=True)

    # 4. first and second tokens against the plain path; for int8, the
    # readings that set its bar: a served run without the flash kernel, and
    # served runs with planted faults
    t0 = time.perf_counter()
    plain = {q: PlainPath(model, params, prompts, q) for q in (False, True)}
    print(f"  plain paths built in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def read(label, done, quantized, bar, plain, must_pass=True):
        exact, first, second = token_readings(done, plain[quantized])
        worst = max(first, second)
        print(f"  [{label}] first token = plain-path argmax for {exact}/"
              f"{len(done)} requests; worst shortfall {first:.4f} sd (first "
              f"token), {second:.4f} sd (second token) of the plain logits "
              f"(bar {bar})", flush=True)
        if must_pass and worst > bar:
            problems.append(f"{label}: tokens off the plain path")
        return worst

    sound = {}
    for r in runs:
        worst = read(r["label"], r["done"], r["quantized"],
                     INT8_BAR_SD if r["quantized"] else FLOAT_BAR_SD, plain)
        if r["quantized"]:
            sound[r["label"]] = worst
        else:
            dev_sd = kernel_deviation(model, params, prompts, plain[False],
                                      r["algo"])
            print(f"  [{r['label']}] kernel-path prefill logits vs plain, "
                  f"max |diff| per request: "
                  f"{[round(d, 4) for d in dev_sd]} sd (a reading, not a "
                  f"gate: float tokens nearer than this to a tie can go "
                  f"either way)", flush=True)
    # the int8 run once more without the flash kernel: plain attention on
    # both sides, so only the GEMM kernels and the batching differ
    _, done, _ = serve(naive, params, prompts, max_new=2, batch_slots=4,
                       max_len=256, quantized=True, gemm_algo="ffip",
                       gemm_impl="cuda")
    sound["int8-ffip, plain attention"] = read(
        "int8-ffip, plain attention", done, True, FLOAT_BAR_SD, plain)
    seen = {}
    for label, (faulty, must_see) in planted_faults(
            params, cfg.n_layers).items():
        _, done, _ = serve(model, faulty, prompts, max_new=2, batch_slots=4,
                           max_len=256, quantized=True, gemm_algo="ffip",
                           gemm_impl="cuda")
        worst = read(f"planted fault: {label}", done, True, INT8_BAR_SD,
                     plain, must_pass=False)
        if must_see:
            seen[label] = worst
    del faulty
    print(f"  int8 bar {INT8_BAR_SD} sd: largest sound reading "
          f"{max(sound.values()):.4f}, smallest reading of a planted fault "
          f"the bar must see {min(seen.values()):.4f}", flush=True)
    problems += [f"planted fault not seen by the int8 bar: {label}"
                 for label, w in seen.items() if w <= INT8_BAR_SD]
    del plain
    print(f"phase check: {time.perf_counter() - t0:.1f} s", flush=True)

    # 5. paged serving through K5: the page pool, prefix sharing, copy on
    # write and chunked prefill; the served runs and their token checks
    t0 = time.perf_counter()
    paged_prompts = make_prompts(cfg.vocab, 8,
                                 np.random.default_rng(args.seed), 16, 65,
                                 shared_prefix=64)
    print(f"phase paged: {PAGED_SLOTS} slots, max_len {PAGED_MAX_LEN}, "
          f"pages of {PAGE_SIZE}, prefill chunks of {PREFILL_CHUNK}; prompt "
          f"lengths {[len(p) for p in paged_prompts]}", flush=True)
    paged_runs = []

    def run_paged(label, m, p, **kw):
        rec, found = serve_paged(m, p, paged_prompts, args.max_new, label,
                                 **kw)
        problems.extend(found)
        paged_runs.append(rec)
        return rec

    flash = dict(paged_attention="flash", prefill_chunk=PREFILL_CHUNK)
    ffip = run_paged("paged flash ffip", model, params, gemm_algo="ffip",
                     decode_chunk=4, **flash)
    int8 = run_paged("paged flash int8-ffip", model, params,
                     gemm_algo="ffip", quantized=True, decode_chunk=1,
                     **flash)
    plain = {q: PlainPath(model, params, paged_prompts, q)
             for q in (False, True)}
    read(ffip["label"], ffip["done"], False, FLOAT_BAR_SD, plain)
    read(int8["label"], int8["done"], True, INT8_BAR_SD, plain)
    del plain
    # Identity runs, at IDENTITY_LAYERS (the first layers of the same
    # weights). Chunking must not change a token: with every prompt in one
    # chunk, int8 and float FFIP must give the tokens they give in chunks of
    # 64 (the GEMMs' k-split plans do not depend on the rows of a dispatch,
    # and K5 and the norms do a row's arithmetic the same way at any chunk
    # width). And the reference's bit-identity contract: gather-paged int8
    # with plain attention must give the contiguous server's tokens.
    n_id = min(IDENTITY_LAYERS, cfg.n_layers)
    cfg_id = dataclasses.replace(cfg, n_layers=n_id)
    model_id = Model(cfg_id)
    naive_id = Model(dataclasses.replace(cfg_id, attention_impl="naive"))
    params_id = dict(params, layers=_first_layers(params["layers"], n_id))
    same = _same(*[run_paged(f"paged flash int8-ffip, {n_id} layers, "
                             f"prefill_chunk {c}", model_id, params_id,
                             gemm_algo="ffip", quantized=True,
                             decode_chunk=1, paged_attention="flash",
                             prefill_chunk=c)
                   for c in (PREFILL_CHUNK, PAGED_MAX_LEN)])
    print(f"  prefill_chunk {PREFILL_CHUNK} vs {PAGED_MAX_LEN} ({n_id} "
          f"layers): int8 tokens {same}", flush=True)
    if same != "identical":
        problems.append("int8 tokens change with the prefill chunk")
    same = _same(*[run_paged(f"paged flash ffip, {n_id} layers, "
                             f"prefill_chunk {c}", model_id, params_id,
                             gemm_algo="ffip", decode_chunk=1,
                             paged_attention="flash", prefill_chunk=c)
                   for c in (PREFILL_CHUNK, PAGED_MAX_LEN)])
    print(f"  prefill_chunk {PREFILL_CHUNK} vs {PAGED_MAX_LEN} ({n_id} "
          f"layers): float ffip tokens {same}", flush=True)
    if same != "identical":
        problems.append("float tokens change with the prefill chunk")
    gather = run_paged(f"paged gather int8-ffip, plain attention, {n_id} "
                       f"layers", naive_id, params_id, gemm_algo="ffip",
                       quantized=True, decode_chunk=1,
                       paged_attention="gather", prefill_chunk=PREFILL_CHUNK)
    _, done, _ = serve(naive_id, params_id, paged_prompts,
                       max_new=args.max_new, batch_slots=PAGED_SLOTS,
                       max_len=PAGED_MAX_LEN, quantized=True,
                       gemm_algo="ffip", gemm_impl="cuda")
    contiguous = dict(tokens={r.rid: list(r.out_tokens) for r in done})
    print(f"  gather-paged vs contiguous (int8, plain attention, {n_id} "
          f"layers): tokens {_same(gather, contiguous)}", flush=True)
    if gather["tokens"] != contiguous["tokens"]:
        problems.append("gather-paged tokens differ from the contiguous "
                        "cache's")
    print(f"phase paged: {time.perf_counter() - t0:.1f} s", flush=True)

    totals = {name: sum(r["counts"][name] for r in runs + paged_runs)
              for name in compat.launch_counts()}
    problems += [f"{name} never launched on the served path"
                 for name, n in totals.items()
                 if n == 0 and name != "conv_gemm"]
    if totals["conv_gemm"]:
        problems.append(f"conv_gemm launched {totals['conv_gemm']} times on "
                        f"the LM paths")
    print(f"launches over the served runs {totals}", flush=True)

    # 6. the CNN path: ResNet-50 and AlexNet through K7 (convs) and K1-K3
    # (FCs), against the plain path
    t0 = time.perf_counter()
    print(f"phase vision: ResNet-50 (224) and AlexNet (227), batch "
          f"{CONV_BATCH}, published widths, 1000 classes, f32 weights from "
          f"seed {args.seed}", flush=True)
    vision_recs, found = run_vision(dev, args.seed)
    problems += found
    totals["conv_gemm"] = sum(r["counts"].get("conv_gemm", 0)
                              for r in vision_recs)
    print(f"phase vision: {time.perf_counter() - t0:.1f} s", flush=True)
    if problems:
        print("FAIL:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1

    # 7. one dispatch of each kind, counted and profiled
    steps = contiguous_steps(model, params, 128)
    steps.update(paged_steps(model, params))
    steps["resnet50 forward"] = vision_step(dev, args.seed)
    for phase, rec in profile(steps).items():
        top = ", ".join(f"{k} {v:.3f}" for k, v in rec["device_ms"].items())
        busy = rec["busy_ms"]
        share = ("not measured" if isinstance(busy, str)
                 else f"{busy / rec['wall_ms']:.3f}")
        print(f"phase profile {phase} (ffip; LM: 4 slots x 128 / a 64-row "
              f"chunk; vision: batch {CONV_BATCH}): wall "
              f"{rec['wall_ms']:.3f} ms, device busy {busy} ms (share "
              f"{share}); device ms by kernel: {top or 'not measured'}; "
              f"launches {rec['launches']}", flush=True)
        # LM: 7 projections per layer plus the unembed; attention once per
        # layer: K4 in the contiguous prefill, K5 in either paged dispatch.
        # Vision: K7 for each of the 53 convs, K3 for the FC.
        want = ({"conv_gemm": 53, "ffip_gemm_y": 1}
                if phase == "resnet50 forward" else
                {"ffip_gemm_y": 7 * cfg.n_layers + 1,
                 "flash_fwd": cfg.n_layers if phase == "prefill" else 0,
                 "flash_paged": cfg.n_layers if "paged" in phase else 0})
        got = {k: rec["launches"][k] for k in want}
        if got != want:
            print(f"FAIL: {phase} launched {got}, expected {want}",
                  file=sys.stderr)
            return 1

    # 8. the kernels line and the result line
    kernels = []
    for name in SOURCES:
        recs_k = [r for r in recs if r["kernel"] == name]
        if name == "conv_gemm":
            head = next(r for r in recs_k if (r["case"], r["dtype"],
                                              r["algo"]) == HEADLINE_CONV)
            shape = (f"{head['case']} batch {head['batch']} (M={head['m']} "
                     f"K={head['k']} N={head['n']}) f32 ffip; library: "
                     f"F.conv2d f32, TF32 off (none for int8: no CUDA int8 "
                     f"conv in PyTorch)")
        elif name == "flash_fwd":
            head = next(r for r in recs_k if r["s"] == HEADLINE_FLASH_S)
            shape = f"BH={head['bh']} S={head['s']} d={head['d']} causal bf16"
        elif name == "flash_paged":
            head = next(r for r in recs_k if (r["case"], r["dtype"])
                        == HEADLINE_PAGED)
            shape = (f"B={head['b']} H={head['h']} KV={head['kv']} "
                     f"Sq={head['sq']} d={head['d']} ps={head['ps']} "
                     f"max_pages={head['max_pages']} bf16 decode; library: "
                     f"page gather + scaled_dot_product_attention")
        else:
            m, k, n, dt = HEADLINE_GEMM
            head = next(r for r in recs_k if (r["m"], r["k"], r["n"],
                                              r["dtype"]) == (m, k, n, dt))
            shape = f"M={m} K={k} N={n} {dt}"
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": totals[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs_k),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": shape,
            "per_shape": [{k: v for k, v in r.items()
                           if k not in ("kernel", "ok")} for r in recs_k]})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
