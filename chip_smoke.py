#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, in order; any failure exits non-zero and prints no result line:

1. Print the card's name and power limit (``nvidia-smi``), then build every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all started together) and print the build time.
2. Hold each kernel against its plain PyTorch version at the main paths'
   shapes: the GEMMs K1-K3 at minicpm-2b's M in {4, 512} x (K, N) in
   {(2304, 2304), (2304, 5760), (5760, 2304), (2304, 122753)} and
   falcon-mamba-7b's M in {4, 128} x (K, N) in {(4096, 16384), (8192, 288),
   (256, 8192), (8192, 4096), (4096, 65024)}, in bf16 (beta unfolded) and
   int8 (beta folded, as the int8 dense layer calls them); the flash kernel
   K4 at BH = 4 x 36 over the prefill buckets S in {16, 32, 64, 128} and
   the trained S 256 (d 64, causal), d 128, d 40, a window of 32 and
   non-causal, bf16 and f32 (FLASH_CASES); the paged kernel K5 at decode
   (B 4, H = KV = 36, Sq 1 and 4, d 64, pages of 16, 16 pages a sequence,
   lengths 17-256 and one of 0), a
   64-row prefill chunk, GQA group 4, a window of 40 and an MLA-like d 576,
   dv 512, in bf16 and f32; the fused conv K7 at seven ResNet-50 / AlexNet
   convs at batch 8 (CONV_CASES), baseline, FIP and FFIP, f32 and int8
   (beta folded), each in the tile ``conv_blocks`` picks; the selective
   scan K6 at falcon-mamba-7b's prefill (B 1, S 16 / 64 / 128, di 8192,
   N 16, bf16), two chunks at B 2, f32, a nonzero
   h0, and a state carried across two calls (SCAN_CASES); the flash backward
   K8 at BH 144, d 64, S 256 / 128 / 200, a window of 32 and non-causal,
   bf16 and f32 (FLASH_BWD_CASES); the scan backward K9 at falcon-mamba-7b's
   widths, B 2 S 256 (two chunks), B 1 S 128 and S 64, f32
   (SCAN_BWD_CASES). Tolerances: int8
   exact; K6's h_final and h_starts rtol = atol = 1e-4 of the plain f32
   values and bf16 y one ulp, the carried state bit for bit; K8's f32
   dq/dk/dv rtol 1e-4, atol 1e-4 * max|plain|, cast to bf16 one ulp beyond
   that atol; K9's five gradients rtol = atol = 1e-4; bf16 and f32
   GEMMs and K7 the
   reference's f32 GEMM bar (rtol 1e-4, atol 1e-3 * max(1, K // 64)), both
   sides summing the same products in f32 in another order; flash o at 2**-7
   (one bf16 rounding of o) and lse at 2e-3; K5 at 2**-7, with exact zeros
   for a sequence of length 0. Each call is timed with CUDA events, L2
   flushed between launches (K1-K4 and their library yardsticks by
   CUDA-graph replay, the time around the call beside it), beside its plain
   version (timed on the call that checks it, after a warm call for the
   cheap K4/K5 ones), its library yardstick and its bound. The GEMM lines
   start with the registers and spills (the build's ``-Xptxas -v``) of each
   instantiation of K1's tensor-core body and of K2/K3's pair body, the
   K4, K7 and K8 lines with those of K4's tensor-core body, K7's FIP/FFIP
   pair kernels and K8's tensor-core passes. K3's carry-table kernel is
   held bit for bit to its plain version on each weight's y and timed on
   the card (the derivation runs once per weight, memoized beside y; the
   K3 calls are timed with it memoized).
3. Batch invariance, bit for bit: rows 0-3 of an M = 512 K1/K2/K3 call
   against the same rows at M = 4, 64 and 256 (f32 and bf16), rows 0-3 of
   falcon-mamba-7b's in_proj (K 4096, N 16384) at M = 128 against M = 1, 4
   and 16, and image 0 of a batch-8 K7 call against the batch-1 call.
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
   (FLOAT_BAR_SD, INT8_BAR_SD). Each bar is held between readings taken in
   the same run: the sound ones (the served shortfalls; for float also each
   prompt's kernel-vs-plain prefill deviation; the int8 run once more with
   plain attention, which must also read within PLAIN_ATTENTION_BAR_SD
   0.05) below it, and served
   runs with a planted fault (a middle layer's attn.wo taken from the next
   layer, served float FFIP and int8 FFIP) above it.
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
9. The Mamba1 path (phase ssm): falcon-mamba-7b at its published widths and
   64 layers, bf16, random weights from --seed, served as in
   4. (every prompt in its own scatter-prefill dispatch) with ffip, fip,
   baseline and int8 ffip. Each run must meet every budget, launch its GEMM
   kernel, and launch K6 exactly once per layer per prompt. Tokens against
   the plain path (plain selective scan included) under the same bars, with
   ssm.out_proj taken from the next layer as the planted fault; then one
   128-token prefill and one decode step profiled.
10. The training path (phase train, TRAIN_RUNS): minicpm-2b at its
   published widths and 40 layers (batch 4 x 256) and falcon-mamba-7b at its
   widths and 48 of 64 layers (batch 2 x 256; 64 layers' bf16 params, grads
   and f32 moments would pass the card's 80 GB), bf16, random weights from
   --seed, 8 AdamW steps (lr TRAIN_LR, WSD, 2 warmup steps) through
   ``train.loop.train`` on batches of the port's data pipeline. Every step
   must launch K4 and K8 (K6 and K9) once per layer and none of K1-K3, K5,
   K7; losses and gradient norms finite, the last loss below the first.
   ms per step, tokens/s, peak memory and one profiled step are printed.
   Then one step's gradients through the kernels against the plain path
   (plain attention; autograd through the plain f32 recurrence) at the
   first IDENTITY_LAYERS layers: the largest per-leaf relative L2 error
   must lie below GRAD_BAR and a planted fault's (a middle layer's output
   projection taken from the next layer) above it. minicpm-2b is trained
   once more at AdamWConfig's default learning rate through the kernels and
   through the plain path: where the plain path's last loss falls below its
   first, the kernels' must too.
11. Print the kernels line (JSON), then the result line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# NVIDIA H100 SXM peaks (data sheet, dense) that bound each call: device
# memory, bf16 and int8 tensor cores, and the f32 CUDA cores: 128 FMA lanes
# per SM on 132 SMs at the 1.98 GHz boost clock. exp runs on the
# special-function units: 16 results per SM per clock (CUDA programming
# guide, arithmetic throughput, compute capability 9.0), at the same clock.
HBM_BYTES_S = 3.35e12
BOOST_CLOCK_HZ = 1.98e9
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12,
              "cuda_core": 2 * 128 * 132 * BOOST_CLOCK_HZ}
SFU_EXP_S = 16 * 132 * BOOST_CLOCK_HZ
# FIP/FFIP's pre-add has no tensor-core mapping, and a pair costs each output
# 2 adds and 1 multiply-add, each an instruction of its own: they are bound
# by issue slots, not by FMA flops. A scheduler issues one warp instruction
# a clock: 128 lanes a SM a clock, the rate of f32 adds and FMAs (same guide
# and table). int32 adds (IADD3, ALU pipe) and multiply-adds (IMAD, FMA
# pipe) run at 64 each, on separate pipes, and ptxas also issues adds as
# IMAD.IADD on the FMA pipe: together they reach the issue limit, with the
# multiply-adds alone held to 64.
ISSUE_RATE_S = 128 * 132 * BOOST_CLOCK_HZ
IMAD_RATE_S = 64 * 132 * BOOST_CLOCK_HZ


def pair_counts(m: int, n: int, k: int, fold_beta: bool):
    """(adds, multiply-adds) of an (M, K) x (K, N) FIP/FFIP product: 2 adds
    + 1 multiply-add per pair and output, one multiply-add per pair for
    each row's alpha and (unless folded) each column's beta."""
    beta = 0 if fold_beta else n * k / 2
    return m * n * k, m * n * k / 2 + m * k / 2 + beta


def pair_ms(adds: float, mads: float, integer: bool) -> float:
    """Least time of the pair arithmetic: every instruction at the issue
    limit; for int32 also the multiply-adds at the IMAD pipe's rate."""
    t = (adds + mads) / ISSUE_RATE_S
    if integer:
        t = max(t, mads / IMAD_RATE_S)
    return t * 1e3

# GEMM checks, (M, K, N): minicpm-2b's projections and tied logits at decode
# (M 4) and prefill (M 512); falcon-mamba-7b's in_proj, x_proj (N 288, not a
# multiple of 64), dt_proj (K 256: 16 FFIP splits), out_proj and tied logits
# at decode (M 4) and at a 128-token prompt (M 128)
GEMM_CASES = tuple(
    (m, k, n) for ms, kns in (
        ((4, 512), ((2304, 2304), (2304, 5760), (5760, 2304),
                    (2304, 122753))),
        ((4, 128), ((4096, 16384), (8192, 288), (256, 8192), (8192, 4096),
                    (4096, 65024))))
    for m in ms for k, n in kns)
HEADLINE_GEMM = (4, 2304, 5760, "bf16")     # decode up/gate projection
# K4 checks at BH = 4 x 36 (minicpm-2b's heads at 4 slots or training batch
# 4): (label, S, d, window, causal), each in bf16 and f32. S 16-128 are the
# served prefill buckets, S 256 the trained sequence; d 128 runs the second
# tensor-core instantiation, d 40 the first zero-filled.
FLASH_CASES = (
    ("S 16", 16, 64, 0, True),
    ("S 32", 32, 64, 0, True),
    ("S 64", 64, 64, 0, True),
    ("S 128", 128, 64, 0, True),
    ("S 256", 256, 64, 0, True),
    ("S 128 d 128", 128, 128, 0, True),
    ("S 128 d 40", 128, 40, 0, True),
    ("window 32", 256, 64, 32, True),
    ("non-causal", 128, 64, 0, False),
)
HEADLINE_FLASH = ("S 128", "bf16")
# Token bars, in standard deviations of the plain-path logits. Each lies
# between the sound readings of its tier and the planted faults it must see;
# every run prints both and fails if the bar no longer lies between them.
# Float: a prompt's prefill logits through the kernels differ from the plain
# path's by up to 0.083-0.111 sd for minicpm-2b (40 layers) and 0.219-0.276
# sd for falcon-mamba-7b (64 layers): bf16 outputs rounded after f32 sums in
# other orders. A served token can fall short of the plain max by about
# twice that (0.552); the served shortfalls read up to 0.122. A middle
# layer's output projection taken from the next layer reads 1.104 (minicpm
# attn.wo) and 0.999 (falcon ssm.out_proj), served through float FFIP.
# (H100 readings; the bar was 0.05 sd before, below the path's own noise.)
# int8: the per-token activation quantization turns bf16-level differences
# (flash vs plain attention) into whole int8 steps. Sound runs read up to
# 0.098 sd (0 with plain attention on both sides); the wrong-layer faults
# 1.006 (minicpm) and 1.046 (falcon).
FLOAT_BAR_SD = 0.6
INT8_BAR_SD = 0.25
# The int8 run with plain attention on both sides, whose int8 sums are exact,
# shows that the flash kernel is the only source of the int8 gap: it is held
# to the float bar's old value, and reads 0 (H100 readings).
PLAIN_ATTENTION_BAR_SD = 0.05
BARS_SD = {"float": FLOAT_BAR_SD, "int8": INT8_BAR_SD}
# K6 checks: (label, B, S, di, N, chunk, dtype, h0 scale), falcon-mamba-7b's
# prefill (the scatter prefill runs one prompt at a time) and the edges;
# check_scan adds every length phase ssm serves (full 32-step tiles and a
# ragged last one)
SCAN_CASES = (
    ("prefill S 16", 1, 16, 8192, 16, 128, "bf16", 0.0),
    ("prefill S 64", 1, 64, 8192, 16, 128, "bf16", 0.0),
    ("prefill S 128", 1, 128, 8192, 16, 128, "bf16", 0.0),
    ("two chunks", 2, 256, 8192, 16, 128, "bf16", 0.1),
    ("f32", 1, 128, 8192, 16, 128, "f32", 0.1),
    ("nonzero h0", 1, 128, 8192, 16, 128, "bf16", 0.1),
)
HEADLINE_SCAN = "prefill S 128"
REPLACES = {
    "baseline_gemm": "src/repro/kernels/baseline_gemm.py:58",
    "fip_gemm": "src/repro/kernels/fip_gemm.py:65",
    "ffip_gemm_y": "src/repro/kernels/ffip_gemm.py:92",
    "ffip_carry_table": "src/repro/kernels/ffip_gemm.py:57",
    "flash_fwd": "src/repro/kernels/flash_attention.py:81",
    "flash_paged": "src/repro/kernels/flash_attention.py:335",
    "conv_gemm": "src/repro/kernels/conv_gemm.py:172",
    "selective_scan": "src/repro/kernels/selective_scan.py:72",
    "flash_bwd": "src/repro/kernels/flash_attention.py:191",
    "selective_scan_bwd": "src/repro/kernels/selective_scan.py:196",
}
SOURCES = {
    "baseline_gemm": "src/repro_torch/kernels/csrc/baseline_gemm.cu",
    "fip_gemm": "src/repro_torch/kernels/csrc/fip_gemm.cu",
    "ffip_gemm_y": "src/repro_torch/kernels/csrc/ffip_gemm.cu",
    "ffip_carry_table": "src/repro_torch/kernels/csrc/ffip_gemm.cu",
    "flash_fwd": "src/repro_torch/kernels/csrc/flash_fwd.cu",
    "flash_paged": "src/repro_torch/kernels/csrc/flash_paged.cu",
    "conv_gemm": "src/repro_torch/kernels/csrc/conv_gemm.cu",
    "selective_scan": "src/repro_torch/kernels/csrc/selective_scan.cu",
    "flash_bwd": "src/repro_torch/kernels/csrc/flash_bwd.cu",
    "selective_scan_bwd": "src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
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
# K8 checks at BH = 4 x 36, d 64 (minicpm-2b's attention at training batch
# 4): (label, S, window, causal), each in bf16 and f32. S 256 is the trained
# sequence; S 200 leaves a ragged last block.
FLASH_BWD_CASES = (
    ("S 256", 256, 0, True),
    ("S 128", 128, 0, True),
    ("S 200", 200, 0, True),
    ("window 32", 256, 32, True),
    ("non-causal", 128, 0, False),
)
HEADLINE_FLASH_BWD = ("S 256", "bf16")
# K9 checks at falcon-mamba-7b's widths, f32 as the Function passes them:
# (label, B, S, di, N, chunk); the trained shape walks two chunks' h_starts,
# S 64 lies below the chunk.
SCAN_BWD_CASES = (
    ("train B 2 S 256", 2, 256, 8192, 16, 128),
    ("B 1 S 128", 1, 128, 8192, 16, 128),
    ("B 1 S 64", 1, 64, 8192, 16, 128),
)
HEADLINE_SCAN_BWD = "train B 2 S 256"
# phase train: (arch, layers, batch, seq). minicpm-2b at its published 40
# layers; falcon-mamba-7b at 48 of its 64: bf16 params and grads and f32
# AdamW moments take 12 B a parameter, 88 GB at 64 layers (7.3 B params),
# more than the card's 80 GB; 48 layers (5.3 B params, ~64 GB) leave room
# for the activations and AdamW's f32 slices.
TRAIN_RUNS = (("minicpm-2b", 40, 4, 256), ("falcon-mamba-7b", 48, 2, 256))
TRAIN_STEPS = 8
# AdamW's peak learning rate in phase train (WSD, 2 warmup steps of 8, as
# the launcher schedules minicpm-2b). At AdamWConfig's default (3e-4) the
# random 40-layer minicpm-2b's loss rises over the 8 steps; every run
# repeats that run through the kernels and through the plain path
# (attention_impl="naive") as the witness that the rise is the model's and
# the schedule's, not the kernels' (lr_witness). Eight steps leave no room
# for the thousands of warmup steps a real run takes.
TRAIN_LR = 1e-4
# Gradient bar: the largest per-leaf relative L2 error of one step's
# gradients through the kernels (K4 + K8, K6 + K9) against the plain path
# (plain attention; autograd through the plain f32 recurrence), on the first
# IDENTITY_LAYERS layers of the same weights and batch. Every run prints the
# largest sound reading and the reading of a planted fault (a middle layer's
# output projection taken from the next layer, on the kernel side only) and
# fails if the bar no longer lies between them. Sound readings: up to 0.0200
# (minicpm-2b, attn.wq: bf16 attention rounded in other places) and 0.0221
# (falcon-mamba-7b, ssm.x_proj: K6's y rounded to bf16 where the plain
# recurrence keeps f32); planted faults 0.950 (minicpm) and 1.138 (falcon)
# (H100 readings).
GRAD_BAR = 0.1

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


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of ``fn`` replayed from a CUDA graph, L2 flushed before
    each replay: for a kernel shorter than its wrapper's host work, which a
    pair of events around the call would time instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                      # warm, off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps)


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


def yardstick_ms(fn, replay: bool = False):
    """Time of the library call that computes the same function (by CUDA
    graph replay with ``replay``, as the kernel it stands beside is timed),
    or None where PyTorch has none for these operands (``torch._int_mm``
    refuses some shapes)."""
    try:
        fn()
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"  (no library yardstick: {str(e).splitlines()[0]})")
        return None
    return graph_ms(fn, 5) if replay else time_ms(fn, 5)


def _err(got: torch.Tensor, want: torch.Tensor):
    d = (got.double() - want.double()).abs()
    return float(d.max()), float((d / want.double().abs().clamp_min(1e-6)).max())


def _allclose(got, want, rtol, atol) -> bool:
    return bool(((got.double() - want.double()).abs()
                 <= atol + rtol * want.double().abs()).all())


def gemm_bound(name: str, m: int, k: int, n: int, dtype: str):
    """(bound_ms, bound_by) of one GEMM call: each input read once (A, then
    B or, for FFIP, its f32/int32 deltas y and their carry table), the
    f32/int32 output written once; baseline at the tensor-core peak of its
    type, FIP/FFIP in issue slots (:func:`pair_counts`, :func:`pair_ms`;
    int8 beta folded)."""
    elt = 2 if dtype == "bf16" else 1
    b_bytes = k * n * elt
    if name == "ffip_gemm_y":
        b_bytes = k * n * 4 + k * -(-n // 32) * 4
    nbytes = m * k * elt + b_bytes + m * n * 4
    if name == "baseline_gemm":
        t_ops = 2.0 * m * n * k / PEAK_OPS_S[dtype] * 1e3
    else:
        t_ops = pair_ms(*pair_counts(m, n, k, fold_beta=dtype == "int8"),
                        integer=dtype == "int8")
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_lines(source: str, key: str):
    """(kernel, "registers, spills") for each kernel of ``source`` whose
    name holds ``key``, from the build's ``-Xptxas -v`` output, demangled
    by c++filt where the toolkit's host has it."""
    from repro_torch.kernels import compat

    out, name = [], None
    for line in compat.build_log.get(source, "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            spills = line.strip()
        elif name and "Used" in line and "registers" in line:
            if key in name:
                regs = line.split(":", 1)[1].strip()
                out.append((name, f"{regs}; {spills}"))
            name = None
    try:
        shown = subprocess.run(["c++filt"], input="\n".join(n for n, _ in out),
                               capture_output=True, text=True,
                               timeout=60).stdout.split("\n")
        out = [(shown[i] or n, v) for i, (n, v) in enumerate(out)]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return out


def check_carry(y: torch.Tensor, carry: torch.Tensor, dtype: str,
                first_ms: float):
    """K3's carry-table kernel on one weight's y against its plain version,
    bit for bit (the same adds in the same order), timed on the card; the
    library yardstick is torch.cumsum over the rows (the table is its every
    32nd column, shifted by one group). ``first_ms``: the memoizing first
    derivation on the host clock."""
    from repro_torch.kernels.ffip_gemm import (GROUP, carry_table,
                                               carry_table_plain)

    k, n = y.shape
    want, plain_ms = timed(lambda: carry_table_plain(y))
    ok = torch.equal(carry, want)
    abs_err = float((carry.double() - want.double()).abs().max())
    fn = lambda: carry_table(y)                  # noqa: E731
    ms = time_ms(fn, reps_for(time_ms(fn, 1)), warm=False)
    lib_ms = yardstick_ms(lambda: torch.cumsum(y, 1))
    t_bytes = (y.numel() + carry.numel()) * 4 / HBM_BYTES_S * 1e3
    t_ops = k * max(0, n - GROUP) / ISSUE_RATE_S * 1e3  # one add an element
    bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                          else (t_ops, "operations"))
    print(f"  ffip_carry_table y ({k}, {n}) {y.dtype} -> "
          f"{tuple(carry.shape)} {'ok ' if ok else 'BAD'} (bit for bit) "
          f"max_abs={abs_err:.3g}  {ms:.4f} ms on the card (first derivation "
          f"{first_ms:.2f} ms host clock)  plain {plain_ms:.3f} ms  cumsum "
          f"{lib_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})",
          flush=True)
    return dict(kernel="ffip_carry_table", k=k, n=n, dtype=dtype, ok=ok,
                max_abs_err=abs_err, max_rel_err=0.0 if ok else float("nan"),
                tol="bit for bit", ms=ms, first_ms=first_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def check_gemms(dev):
    """K1-K3 against their plain versions at the main path's shapes."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.baseline_gemm import (baseline_gemm,
                                                   baseline_gemm_plain)
    from repro_torch.kernels.ffip_gemm import (carry_for, ffip_gemm_y,
                                               ffip_gemm_y_plain, y_for)
    from repro_torch.kernels.fip_gemm import fip_gemm, fip_gemm_plain

    for source, key in (("baseline_gemm", "baseline_tc"),
                        ("fip_gemm", "fip_pair_kernel"),
                        ("ffip_gemm", "ffip_pair_kernel")):
        for name, regs in ptxas_lines(source, key):
            print(f"  ptxas {name}: {regs}", flush=True)
    records, carried = [], set()
    g = torch.Generator(device=dev).manual_seed(0)
    for m, k, n in GEMM_CASES:
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
            mac = dict(zip(("bm", "bn", "bk"),
                           ops.choose_blocks(m, n, k, "baseline", a.dtype)))
            blk = dict(zip(("bm", "bn", "bk"),
                           ops.choose_blocks(m, n, k, "ffip")))
            y = y_for(b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            carry = carry_for(y)          # the K3 calls below reuse it
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            if (k, n, dtype) not in carried:
                carried.add((k, n, dtype))
                records.append(check_carry(y, carry, dtype, first_ms))
            calls = {
                "baseline_gemm": (
                    lambda: baseline_gemm(a, b, **mac),
                    lambda: baseline_gemm_plain(a, b, **mac)),
                "fip_gemm": (
                    lambda: fip_gemm(a, b, fold_beta=fold, **blk),
                    lambda: fip_gemm_plain(a, b, fold_beta=fold,
                                           k_chunk=kc, **blk)),
                "ffip_gemm_y": (
                    lambda: ffip_gemm_y(a, y, fold_beta=fold, **blk),
                    lambda: ffip_gemm_y_plain(a, y, fold_beta=fold,
                                              k_chunk=kc, **blk)),
            }
            lib_ms = yardstick_ms(lib, replay=True)
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
                call_ms = time_ms(kern, reps_for(one), warm=False)
                ms = graph_ms(kern, reps_for(one))
                bound_ms, bound_by = gemm_bound(name, m, k, n, dtype)
                tiles = mac if name == "baseline_gemm" else blk
                rec = dict(kernel=name, m=m, k=k, n=n, dtype=dtype,
                           tile=(tiles["bm"], tiles["bn"]),
                           fold_beta=fold, ok=ok, max_abs_err=abs_err,
                           max_rel_err=rel_err, tol=tol, ms=ms,
                           call_ms=call_ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
                records.append(rec)
                print(f"  {name:13s} M={m:<3d} K={k:<4d} N={n:<6d} "
                      f"{dtype:4s} tile {tiles['bm']}x{tiles['bn']} "
                      f"{'ok ' if ok else 'BAD'} "
                      f"max_abs={abs_err:.3g} max_rel={rel_err:.3g} "
                      f"({tol})  {ms:.4f} ms (call {call_ms:.4f})  "
                      f"plain {plain_ms:.3f} ms  "
                      f"lib {lib_ms if lib_ms is None else round(lib_ms, 4)}"
                      f" ms  bound {bound_ms:.4f} ms ({bound_by})",
                      flush=True)
                del got, want
            del a, b, y, carry
    return records


def check_flash(dev):
    """K4 against its plain version at FLASH_CASES, bf16 (tensor cores) and
    f32 (CUDA cores): o within 2**-7 (bf16) or 2e-3 (f32), lse within 2e-3.
    K4 and the library yardstick (scaled_dot_product_attention, a boolean
    mask for the window) are both timed by CUDA-graph replay, L2 flushed.
    Bound: q, k, v and o read or written once and lse written once, against
    4 d flops per kept (q, k) pair (the QK and PV products) at the bf16
    tensor-core peak, or the f32 CUDA-core peak for f32."""
    from repro_torch.kernels.flash_attention import _flash_fwd, _flash_fwd_plain
    import torch.nn.functional as F

    for name, regs in ptxas_lines("flash_fwd", "_tc_kernel"):
        print(f"  ptxas {name}: {regs}", flush=True)
    records = []
    g = torch.Generator(device=dev).manual_seed(1)
    bh = 4 * 36
    for label, s, d, window, causal in FLASH_CASES:
        pos = torch.arange(s, device=dev)
        keep = torch.ones((s, s), dtype=torch.bool, device=dev)
        if causal:
            keep &= pos[:, None] >= pos[None, :]
        if window > 0:
            keep &= (pos[:, None] - pos[None, :]) < window
        pairs = int(keep.sum())
        for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            q, k, v = (torch.randn((bh, s, d), generator=g, device=dev).to(
                dtype) for _ in range(3))
            kern = lambda: _flash_fwd(q, k, v, window,        # noqa: E731
                                      causal=causal)
            o, lse = kern()
            torch.cuda.synchronize()
            plain = lambda: _flash_fwd_plain(q, k, v, window,  # noqa: E731
                                             causal=causal)
            plain()                               # warm: first-use set-up
            (o_ref, lse_ref), plain_ms = timed(plain)
            o_err, _ = _err(o, o_ref)
            lse_err, _ = _err(lse, lse_ref)
            o_tol = 2 ** -7 if dtype == torch.bfloat16 else 2e-3
            ok = (_allclose(o, o_ref, o_tol, o_tol)
                  and _allclose(lse, lse_ref, 2e-3, 2e-3))
            if window > 0:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q[None], k[None], v[None], attn_mask=keep)
            else:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q[None], k[None], v[None], is_causal=causal)
            call_ms = time_ms(kern, 20)
            ms = graph_ms(kern)
            lib_ms = yardstick_ms(lib, replay=True)
            peak = PEAK_OPS_S["bf16" if dtype == torch.bfloat16
                              else "cuda_core"]
            t_ops = 4.0 * bh * pairs * d / peak * 1e3
            t_bytes = ((4 * bh * s * d * q.element_size() + bh * s * 4)
                       / HBM_BYTES_S * 1e3)
            bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                                  else (t_ops, "operations"))
            records.append(dict(kernel="flash_fwd", case=label, bh=bh, s=s,
                                d=d, window=window, causal=causal,
                                dtype=dname, ok=ok,
                                max_abs_err=max(o_err, lse_err), ms=ms,
                                call_ms=call_ms, plain_ms=plain_ms,
                                library_ms=lib_ms, bound_ms=bound_ms,
                                bound_by=bound_by, kept_pairs=pairs * bh,
                                tol=f"o {o_tol:g}, lse 2e-3"))
            lib_txt = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
            print(f"  flash_fwd     {label:11s} BH={bh} S={s:<3d} d={d:<3d} "
                  f"{dname:4s} {'ok ' if ok else 'BAD'} o_err={o_err:.3g} "
                  f"lse_err={lse_err:.3g}  {ms:.4f} ms (graph replay; "
                  f"{call_ms:.4f} ms around the call)  plain "
                  f"{plain_ms:.3f} ms  sdpa {lib_txt}  bound "
                  f"{bound_ms:.5f} ms ({bound_by})", flush=True)
            del q, k, v, o, lse, o_ref, lse_ref
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
               m: int, k: int, fold_beta: bool):
    """(bound_ms, bound_by) of one K7 call: the padded input read once, the
    weights (FFIP: their f32/int32 deltas) and the f32/int32 output once.
    Baseline: 2 M N K operations (over all groups) at the f32 CUDA-core peak
    (no TF32), or the int8 tensor-core peak for int8. FIP/FFIP: issue slots
    (:func:`pair_counts` per group, :func:`pair_ms`)."""
    g, _, ng = stack.shape
    w_elt = 4 if algo == "ffip" else stack.element_size()
    nbytes = (xp.numel() * xp.element_size() + stack[:, :k].numel() * w_elt
              + m * g * ng * 4)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    if algo == "baseline":
        peak = PEAK_OPS_S["int8" if dtype == "int8" else "cuda_core"]
        t_ops = 2.0 * m * g * ng * k / peak * 1e3
    else:
        adds, mads = pair_counts(m, ng, k + k % 2, fold_beta)
        t_ops = pair_ms(g * adds, g * mads, integer=dtype == "int8")
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

    for name, regs in ptxas_lines("conv_gemm", "pair_kernel"):
        print(f"  ptxas {name}: {regs}", flush=True)
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
            for algo in ("baseline", "fip", "ffip"):
                fold = dtype == "int8" and algo != "baseline"
                bg = {"baseline": stack, "fip": cg._evenize_k(stack),
                      "ffip": cg._y_even(stack)}[algo]
                bm, bn, bk = cg.conv_blocks(m, cout // groups, bg.shape[1],
                                            algo, groups)
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
                                                geom.k, fold)
                records.append(dict(
                    kernel="conv_gemm", case=label, algo=algo, dtype=dtype,
                    batch=CONV_BATCH, m=m, k=geom.k, n=cout, groups=groups,
                    tile=f"{bm}x{bn}",
                    fold_beta=fold, ok=ok, max_abs_err=abs_err,
                    max_rel_err=rel_err, tol=tol, ms=ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by))
                lib = ("none (no CUDA int8 conv)" if lib_ms is None
                       else f"{lib_ms:.4f} ms")
                print(f"  conv_gemm     {label:17s} M={m:<6d} K={geom.k:<4d} "
                      f"N={cout:<4d} g{groups} {algo:8s} {dtype:4s} "
                      f"{bm}x{bn} "
                      f"{'ok ' if ok else 'BAD'} max_abs={abs_err:.3g} "
                      f"({tol})  {ms:.4f} ms  plain {plain_ms:.3f} ms  "
                      f"conv2d {lib}  bound {bound_ms:.4f} ms ({bound_by})",
                      flush=True)
                del got, want
            del x, kern, xp, stack
    return records


def bf16_ulps(got: torch.Tensor, want: torch.Tensor,
              atol: float = 0.0) -> float:
    """Largest |got - want| beyond ``atol`` in units of the bf16 spacing at
    ``want`` (2**(e - 7) for |want| in [2**e, 2**(e + 1))). K8 passes its f32
    bar's atol: a gradient that cancels to near 0 is noise at that floor in
    either type."""
    _, e = torch.frexp(want.float().abs().clamp_min(2.0 ** -126))
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32), e - 8)
    excess = ((got.float() - want.float()).abs() - atol).clamp_min(0)
    return float((excess / ulp).max())


def scan_bound(bt: int, s: int, di: int, n: int, chunk: int, elt: int):
    """(bound_ms, bound_by) of one K6 call: x, dt, B, C read once and y
    written once in the input type; A, h0, h_final and the h_starts
    checkpoints in f32; against the S di N exponentials at SFU_EXP_S (the
    recurrence's other five f32 operations per state and step take a third
    of that time at the CUDA-core peak)."""
    nbytes = ((3 * bt * s * di + 2 * bt * s * n) * elt
              + (di * n + 2 * bt * di * n + bt * (s // chunk) * di * n) * 4)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = bt * s * di * n / SFU_EXP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_scan(dev, served_lengths):
    """K6 against its plain version (SCAN_CASES, and falcon-mamba-7b's
    prefill at each of ``served_lengths``): h_final and h_starts
    within rtol = atol = 1e-4 of the plain f32 values (the bar
    tests/test_selective_scan.py holds the reference kernel to), y within
    one bf16 ulp in bf16 (both round an f32 sum, taken in another order,
    once) and 1e-4 in f32. Then a state carried across two 128-step calls
    must equal one 256-step call bit for bit. PyTorch has no call that
    computes a selective scan, so there is no library yardstick."""
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_plain)

    records = []
    g = torch.Generator(device=dev).manual_seed(5)

    def operands(bt, s, di, n, dtype, h0_scale):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev)
        x = rnd(bt, s, di).to(dtype)
        dt = torch.nn.functional.softplus(rnd(bt, s, di) - 1).to(dtype)
        b, c = rnd(bt, s, n).to(dtype), rnd(bt, s, n).to(dtype)
        a = -torch.exp(rnd(di, n) * 0.3)
        return x, dt, b, c, a, rnd(bt, di, n) * h0_scale

    served = tuple((f"served S {s}", 1, s, 8192, 16, 128, "bf16", 0.0)
                   for s in sorted(set(served_lengths)))
    for label, bt, s, di, n, chunk, dname, h0_scale in SCAN_CASES + served:
        dtype = torch.bfloat16 if dname == "bf16" else torch.float32
        args = operands(bt, s, di, n, dtype, h0_scale)
        kern = lambda: selective_scan(*args, chunk=chunk)     # noqa: E731
        y, h, starts = kern()
        torch.cuda.synchronize()
        plain = lambda: selective_scan_plain(*args, chunk=chunk)  # noqa: E731
        plain()                                   # warm: first-use set-up
        (y_ref, h_ref, starts_ref), plain_ms = timed(plain)
        state_ok = (_allclose(h, h_ref, 1e-4, 1e-4)
                    and _allclose(starts, starts_ref, 1e-4, 1e-4))
        if dtype == torch.bfloat16:
            y_err = bf16_ulps(y, y_ref)
            y_ok, tol = y_err <= 1.0, "y 1 bf16 ulp, h rtol=atol=1e-4"
            y_txt = f"y {y_err:.2f} ulp"
        else:
            y_ok, tol = _allclose(y, y_ref, 1e-4, 1e-4), "rtol=atol=1e-4"
            y_txt = f"y max_abs {_err(y, y_ref)[0]:.3g}"
        state_err = max(_err(h, h_ref)[0], _err(starts, starts_ref)[0])
        abs_err = max(_err(y, y_ref)[0], state_err)
        ok = y_ok and state_ok
        call_ms = time_ms(kern, 20)
        ms = graph_ms(kern)
        bound_ms, bound_by = scan_bound(bt, s, di, n, chunk,
                                        y.element_size())
        records.append(dict(kernel="selective_scan", case=label, b=bt, s=s,
                            di=di, n=n, chunk=chunk, dtype=dname, ok=ok,
                            max_abs_err=abs_err, ms=ms, call_ms=call_ms,
                            plain_ms=plain_ms,
                            library_ms=None, bound_ms=bound_ms,
                            bound_by=bound_by, tol=tol))
        print(f"  selective_scan {label:13s} B={bt} S={s:<3d} di={di} N={n} "
              f"chunk {chunk} {dname:4s} {'ok ' if ok else 'BAD'} {y_txt}, "
              f"h/h_starts max_abs {state_err:.3g} "
              f"({tol})  {ms:.4f} ms (graph replay; {call_ms:.4f} ms around "
              f"the call)  plain {plain_ms:.3f} ms  library none  "
              f"bound {bound_ms:.5f} ms ({bound_by})", flush=True)
        del args, y, h, starts, y_ref, h_ref, starts_ref
    # a state carried across two calls equals one call
    x, dt, b, c, a, h0 = operands(1, 256, 8192, 16, torch.bfloat16, 0.1)
    whole = selective_scan(x, dt, b, c, a, h0)
    parts = [selective_scan(x[:, :128].contiguous(), dt[:, :128].contiguous(),
                            b[:, :128].contiguous(), c[:, :128].contiguous(),
                            a, h0)]
    parts.append(selective_scan(
        x[:, 128:].contiguous(), dt[:, 128:].contiguous(),
        b[:, 128:].contiguous(), c[:, 128:].contiguous(), a, parts[0][1]))
    torch.cuda.synchronize()
    same = (torch.equal(torch.cat([parts[0][0], parts[1][0]], 1), whole[0])
            and torch.equal(parts[1][1], whole[1])
            and torch.equal(torch.cat([parts[0][2], parts[1][2]], 1),
                            whole[2]))
    print(f"  selective_scan carried state: two calls of 128 steps vs one of "
          f"256 (y, h_final, h_starts): {'identical' if same else 'DIFFER'}",
          flush=True)
    records.append(dict(kernel="selective_scan", case="carried state", b=1,
                        s=256, di=8192, n=16, chunk=128, dtype="bf16",
                        ok=same, max_abs_err=0.0 if same else float("nan"),
                        tol="bit for bit"))
    return records


def flash_bwd_bound(bh: int, s: int, d: int, pairs: int, elt: int):
    """(bound_ms, bound_by) of one K8 call: q, k, v, o and do read once in
    their type and lse in f32; dq, dk, dv written once in f32; against 10 d
    flops per kept (q, k) pair (s, dp, dv, dk, dq: a multiply and an add
    each) at the bf16 tensor-core peak."""
    nbytes = bh * s * d * (5 * elt + 3 * 4) + bh * s * 4
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 10.0 * d * pairs * bh / PEAK_OPS_S["bf16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_flash_bwd(dev):
    """K8 against its plain version (FLASH_BWD_CASES, bf16 and f32): the
    f32 dq, dk, dv within rtol 1e-4, atol 1e-4 * max|plain| (the same
    products summed in another block order); the outputs cast to bf16, as
    the Function casts them for bf16 inputs, within one bf16 ulp beyond that
    atol (a row that keeps one key has dp - delta = 0 up to the order of two
    sums: its dq is ~1e-8 in the plain version and 0 in the kernel). o and lse
    come from K4. K8 and the library yardstick (``sdpa_backward``) are both
    timed by CUDA-graph replay."""
    from repro_torch.kernels.flash_attention import (_flash_bwd,
                                                     _flash_bwd_plain,
                                                     _flash_fwd)

    for name, regs in ptxas_lines("flash_bwd", "_tc_kernel"):
        print(f"  ptxas {name}: {regs}", flush=True)
    records = []
    g = torch.Generator(device=dev).manual_seed(11)
    bh, d = 4 * 36, 64
    for label, s, window, causal in FLASH_BWD_CASES:
        pos = torch.arange(s, device=dev)
        keep = torch.ones((s, s), dtype=torch.bool, device=dev)
        if causal:
            keep &= pos[:, None] >= pos[None, :]
        if window > 0:
            keep &= (pos[:, None] - pos[None, :]) < window
        pairs = int(keep.sum())
        for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            q, k, v, do = (torch.randn((bh, s, d), generator=g,
                                       device=dev).to(dtype)
                           for _ in range(4))
            o, lse = _flash_fwd(q, k, v, window, causal=causal)
            kern = lambda: _flash_bwd(q, k, v, o, lse, do, window,  # noqa
                                      causal=causal)
            got = kern()
            torch.cuda.synchronize()
            plain = lambda: _flash_bwd_plain(q, k, v, o, lse, do,   # noqa
                                             window, causal=causal)
            plain()                               # warm: first-use set-up
            want, plain_ms = timed(plain)
            errs = [_err(a, b)[0] for a, b in zip(got, want)]
            atols = [1e-4 * float(b.abs().max()) for b in want]
            ok = all(_allclose(a, b, 1e-4, t)
                     for a, b, t in zip(got, want, atols))
            ulps = max(bf16_ulps(a.to(torch.bfloat16), b.to(torch.bfloat16),
                                 atol=t)
                       for a, b, t in zip(got, want, atols))
            ok = ok and ulps <= 1.0
            call_ms = time_ms(kern, 20)
            ms = graph_ms(kern)
            bias = None
            if window > 0:
                bias = torch.zeros((s, s), dtype=dtype, device=dev)
                bias = bias.masked_fill(~keep, float("-inf"))[None, None]
                bias = bias.expand(1, bh, s, s)
            lib_op, lib_ms, lib_err = sdpa_backward(
                q, k, v, do, bias, causal and window <= 0, want[0])
            bound_ms, bound_by = flash_bwd_bound(bh, s, d, pairs,
                                                 q.element_size())
            records.append(dict(kernel="flash_bwd", case=label, bh=bh, s=s,
                                d=d, window=window, causal=causal,
                                dtype=dname, ok=ok, max_abs_err=max(errs),
                                bf16_ulps=ulps, ms=ms, call_ms=call_ms,
                                plain_ms=plain_ms, library_ms=lib_ms,
                                library_op=lib_op, bound_ms=bound_ms,
                                bound_by=bound_by, kept_pairs=pairs * bh,
                                tol="rtol 1e-4, atol 1e-4 max|plain|; bf16 "
                                    "cast 1 ulp beyond that atol"))
            print(f"  flash_bwd     {label:10s} BH={bh} S={s:<3d} d={d} "
                  f"{dname:4s} {'ok ' if ok else 'BAD'} dq/dk/dv max_abs "
                  f"{max(errs):.3g}, bf16 cast {ulps:.2f} ulp  {ms:.4f} ms "
                  f"(graph replay; {call_ms:.4f} ms around the call)  plain "
                  f"{plain_ms:.3f} ms  {lib_op} {lib_ms} ms (its dq off the "
                  f"plain by {lib_err})  bound {bound_ms:.5f} ms "
                  f"({bound_by})", flush=True)
            del q, k, v, do, o, lse, got, want, bias
    return records


def sdpa_backward(q, k, v, do, bias, is_causal: bool, plain_dq):
    """(op, ms, max |dq - plain dq|) of scaled_dot_product_attention's own
    backward kernel, called directly on the saved outputs of its forward at
    (1, BH, S, d), as SDPA picks them: flash attention's for bf16 with no
    mask, memory-efficient attention's for f32 or a mask (an additive bias).
    Timed alone by CUDA-graph replay; (op, None, None) where the call is
    refused."""
    aten = torch.ops.aten
    q4, k4, v4, do4 = (t[None] for t in (q, k, v, do))
    try:
        if q.dtype == torch.bfloat16 and bias is None:
            op = "flash_attention_backward"
            o, lse, cq, ck, mq, mk, seed, off = \
                aten._scaled_dot_product_flash_attention(
                    q4, k4, v4, 0.0, is_causal)[:8]

            def bwd():
                return aten._scaled_dot_product_flash_attention_backward(
                    do4, q4, k4, v4, o, lse, cq, ck, mq, mk, 0.0, is_causal,
                    seed, off)
        else:
            op = "efficient_attention_backward"
            o, lse, seed, off = aten._scaled_dot_product_efficient_attention(
                q4, k4, v4, bias, True, 0.0, is_causal)

            def bwd():
                return aten._scaled_dot_product_efficient_attention_backward(
                    do4, q4, k4, v4, bias, o, lse, seed, off, 0.0,
                    [True, True, True, False], is_causal)
        dq = bwd()[0][0]
        torch.cuda.synchronize()
        err = float((dq.double() - plain_dq.double()).abs().max())
        return op, graph_ms(bwd), err
    except (RuntimeError, TypeError) as e:
        print(f"  (no library yardstick: {str(e).splitlines()[0]})")
        return "sdpa backward", None, None


def scan_bwd_bound(bt: int, s: int, di: int, n: int, chunk: int):
    """(bound_ms, bound_by) of one K9 call, all f32: x, dt, dy, B, C, A and
    h_starts read once; dx, ddt, the summed dB, dC and dA written once;
    against the S di N exponentials the function needs at SFU_EXP_S: one
    exp(dt A) per (t, d, n) serves both the recomputed h_t and the adjoint's
    dh_{t-1} (K9 itself takes each twice and more, see its source)."""
    nbytes = 4 * (3 * bt * s * di + 2 * bt * s * n + di * n
                  + bt * (s // chunk) * di * n
                  + 2 * bt * s * di + 2 * bt * s * n + di * n)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 1.0 * bt * s * di * n / SFU_EXP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_scan_bwd(dev):
    """K9 against its plain version (SCAN_BWD_CASES): dx, ddt, dB, dC and
    dA within rtol = atol = 1e-4 of the plain f32 values (both recompute h
    from K6's h_starts and sum in the same orders, so 0 is the aim). No
    PyTorch call computes a selective-scan backward: no library yardstick."""
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_bwd,
                                                    selective_scan_bwd_plain)

    records = []
    g = torch.Generator(device=dev).manual_seed(13)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    for label, bt, s, di, n, chunk in SCAN_BWD_CASES:
        x = rnd(bt, s, di)
        dt = torch.nn.functional.softplus(rnd(bt, s, di) - 1)
        b, c = rnd(bt, s, n), rnd(bt, s, n)
        a = -torch.exp(rnd(di, n) * 0.3)
        dy = rnd(bt, s, di)
        h0 = torch.zeros((bt, di, n), device=dev)
        _, _, starts = selective_scan(x, dt, b, c, a, h0, chunk=chunk)
        args = (x, dt, b, c, a, starts, dy)
        kern = lambda: selective_scan_bwd(*args, chunk=chunk)   # noqa: E731
        got = kern()
        torch.cuda.synchronize()
        plain = lambda: selective_scan_bwd_plain(*args, chunk=chunk)  # noqa
        plain()
        want, plain_ms = timed(plain)
        ok = all(_allclose(p, q, 1e-4, 1e-4) for p, q in zip(got, want))
        exact = sum(int(torch.equal(p, q)) for p, q in zip(got, want))
        abs_err = max(_err(p, q)[0] for p, q in zip(got, want))
        call_ms = time_ms(kern, 20)
        ms = graph_ms(kern)
        bound_ms, bound_by = scan_bwd_bound(bt, s, di, n, chunk)
        records.append(dict(kernel="selective_scan_bwd", case=label, b=bt,
                            s=s, di=di, n=n, chunk=chunk, dtype="f32", ok=ok,
                            exact_outputs=exact, max_abs_err=abs_err, ms=ms,
                            call_ms=call_ms, plain_ms=plain_ms,
                            library_ms=None, bound_ms=bound_ms,
                            bound_by=bound_by, tol="rtol=atol=1e-4"))
        print(f"  selective_scan_bwd {label:15s} B={bt} S={s:<3d} di={di} "
              f"N={n} chunk {min(chunk, s)} f32 {'ok ' if ok else 'BAD'} "
              f"dx/ddt/dB/dC/dA max_abs {abs_err:.3g}, {exact}/5 bit for bit "
              f"(rtol=atol=1e-4)  {ms:.4f} ms (graph replay; {call_ms:.4f} "
              f"ms around the call)  plain {plain_ms:.3f} ms  library none  "
              f"bound {bound_ms:.5f} ms ({bound_by})", flush=True)
        del x, dt, b, c, a, dy, starts, args, got, want
    return records


def check_batch_invariance(dev):
    """Bit for bit: rows 0-3 of an M = 512 K1/K2/K3 call against the same
    rows at M = 4, 64 and 256 (f32 and bf16, at the served (K, N) pairs),
    rows 0-3 of falcon-mamba-7b's in_proj (K 4096, N 16384) at M = 128
    against M = 1, 4 and 16 (row 0 at M = 1), and image 0 of a batch-8 K7
    call against the batch-1 call (f32, the three algos, ResNet-50's
    s2b1.c2). Returns the failures."""
    from repro_torch.kernels import conv_gemm as cg
    from repro_torch.kernels import ops
    from repro_torch.kernels.baseline_gemm import baseline_gemm
    from repro_torch.kernels.ffip_gemm import ffip_gemm_y, y_for
    from repro_torch.kernels.fip_gemm import fip_gemm

    bad = []
    g = torch.Generator(device=dev).manual_seed(7)
    for m_full, k, n, ms in ((512, 2304, 5760, (4, 64, 256)),
                             (512, 5760, 2304, (4, 64, 256)),
                             (128, 4096, 16384, (1, 4, 16))):
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn((m_full, k), generator=g, device=dev).to(dtype)
            b = (torch.randn((k, n), generator=g, device=dev)
                 / k ** 0.5).to(dtype)
            y = y_for(b)

            def blk(rows, algo):
                return dict(zip(("bm", "bn", "bk"),
                                ops.choose_blocks(rows, n, k, algo, dtype)))
            fns = {"baseline_gemm": lambda a_: baseline_gemm(
                       a_, b, **blk(len(a_), "baseline")),
                   "fip_gemm": lambda a_: fip_gemm(
                       a_, b, **blk(len(a_), "fip")),
                   "ffip_gemm_y": lambda a_: ffip_gemm_y(
                       a_, y, **blk(len(a_), "ffip"))}
            for name, fn in fns.items():
                full = fn(a)[:4]
                same = {m: torch.equal(fn(a[:m].contiguous())[:4],
                                       full[:min(m, 4)])
                        for m in ms}
                print(f"  batch invariance {name:13s} K={k} N={n} "
                      f"{str(dtype)[6:]:8s} rows 0-3 at M={m_full} vs "
                      f"M={'/'.join(map(str, ms))}: "
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


@contextlib.contextmanager
def plain_scan():
    """The Mamba1 mixer calls K6's plain version instead of the kernel while
    this is open (the plain path's counterpart of plain attention)."""
    from repro_torch.kernels import selective_scan as ssk
    from repro_torch.models import ssm

    ssm.ssk = types.SimpleNamespace(selective_scan=ssk.selective_scan_plain)
    try:
        yield
    finally:
        ssm.ssk = ssk


class PlainPath:
    """The plain path on one prompt set: torch.matmul (float) or the plain
    int8 algebra, plain attention and the plain selective scan, one prompt
    at a time. It keeps each prompt's prefill logits and cache, so that a
    decode step fed a served first token gives the plain logits of the
    served second token."""

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
        from repro_torch.core.gemm import use_gemm
        stack = contextlib.ExitStack()
        stack.enter_context(use_gemm(self.gemm))
        stack.enter_context(torch.no_grad())
        stack.enter_context(plain_scan())
        return stack

    def second(self, rid: int, first_tok: int) -> torch.Tensor:
        """Plain logits after the prompt and ``first_tok``, kept per
        (request, token): the served runs mostly agree on first tokens.
        Each call decodes from a copy of the prompt's cache: a K/V row would
        merely be rewritten, but an SSM state is advanced in place."""
        key = (rid, first_tok)
        if key not in self._second:
            tok = torch.tensor([[first_tok]], device=self.model.device)
            cache = _tree_clone(self.caches[rid])
            with self._scope():
                _, logits = self.model.decode_step(self.params, tok, cache,
                                                   self.lens[rid])
            self._second[key] = logits[0].float()
        return self._second[key]


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    return tree.clone()


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


def _swap_leaf(params, group: str, name: str, leaf):
    """A copy of ``params`` with ``layers.<group>.<name>.w`` replaced."""
    lay = params["layers"]
    out = dict(params)
    out["layers"] = dict(lay)
    out["layers"][group] = dict(lay[group])
    out["layers"][group][name] = dict(lay[group][name], w=leaf)
    return out


def wrong_layer(params, group: str, name: str, n_layers: int):
    """(label, params) with a middle layer's ``<group>.<name>`` weights
    taken from the next layer: a fault every token check must see."""
    w = params["layers"][group][name]["w"]
    mid = (n_layers - 1) // 2
    bad = w.clone()
    bad[mid] = w[mid + 1]
    return (f"{group}.{name} of layer {mid} taken from layer {mid + 1}",
            _swap_leaf(params, group, name, bad))


def int8_step_faults(params, n_layers: int):
    """Faults below what a token check resolves, printed and not gated: one
    int8 quantization step (the column's range / 255) more in every weight
    of the last layer's, then of every layer's, ``ffn.down``. Their readings
    fall among the sound ones; the exact int8 kernel checks and the
    bit-exact CPU tests stand for that size of fault."""
    down = params["layers"]["ffn"]["down"]["w"]

    def one_step_high(layers):
        out = down.clone()
        sel = down[layers].float()
        step = (sel.amax(-2, keepdim=True) - sel.amin(-2, keepdim=True)) / 255
        out[layers] = (sel + step).to(down.dtype)
        return out

    return {
        f"ffn.down of layer {n_layers - 1} one int8 step high": _swap_leaf(
            params, "ffn", "down", one_step_high(slice(-1, None))),
        "ffn.down of every layer one int8 step high": _swap_leaf(
            params, "ffn", "down", one_step_high(slice(None))),
    }


class Readings:
    """Token readings against the plain path, and the witnesses of each
    bar: every sound reading must lie below it, every reading of a planted
    fault it must see above it."""

    def __init__(self, problems):
        self.problems = problems
        self.sound = {"float": {}, "int8": {}}
        self.faults = {"float": {}, "int8": {}}

    def read(self, label, done, plain: PlainPath, tier: str, *,
             fault: bool = False, gated: bool = True) -> float:
        """Print a run's worst first- and second-token shortfall; a sound
        run must not exceed its tier's bar."""
        bar = BARS_SD[tier]
        exact, first, second = token_readings(done, plain)
        worst = max(first, second)
        print(f"  [{label}] first token = plain-path argmax for {exact}/"
              f"{len(done)} requests; worst shortfall {first:.4f} sd (first "
              f"token), {second:.4f} sd (second token) of the plain logits "
              f"({tier} bar {bar})", flush=True)
        if gated:
            (self.faults if fault else self.sound)[tier][label] = worst
        if gated and not fault and worst > bar:
            self.problems.append(f"{label}: tokens off the plain path")
        return worst

    def deviation(self, label, devs):
        """A float run's kernel-vs-plain prefill deviations: sound readings
        of the float bar."""
        print(f"  [{label}] kernel-path prefill logits vs plain, max |diff| "
              f"per request: {[round(d, 4) for d in devs]} sd", flush=True)
        self.sound["float"][f"{label} (kernel deviation)"] = max(devs)

    def gate(self):
        for tier, bar in BARS_SD.items():
            sound = self.sound[tier]
            faults = self.faults[tier]
            top = max(sound, key=sound.get)
            low = min(faults, key=faults.get)
            print(f"  {tier} bar {bar} sd: largest sound reading "
                  f"{sound[top]:.4f} ({top}); smallest reading of a planted "
                  f"fault {faults[low]:.4f} ({low})", flush=True)
            if not sound[top] < bar < faults[low]:
                self.problems.append(
                    f"the {tier} bar {bar} does not lie between its sound "
                    f"readings (up to {sound[top]:.4f}) and its planted "
                    f"faults (from {faults[low]:.4f})")


def served_prompts(vocab: int, seed: int):
    """The 8 prompts of 16-128 tokens that phases serve and ssm serve; their
    lengths depend on ``seed`` only."""
    from repro_torch.launch.serve import make_prompts
    return make_prompts(vocab, 8, np.random.default_rng(seed), 16, 129)


def drive_main_path(model, params, prompts, max_new: int, tag: str = ""):
    """The served runs; launch counts zeroed before and read after each."""
    from repro_torch.kernels import compat
    from repro_torch.launch.serve import serve

    runs = []
    for algo, quantized in (("ffip", False), ("fip", False),
                            ("baseline", False), ("ffip", True)):
        label = tag + ("int8-" if quantized else "") + algo
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
        torch.cuda.empty_cache()      # the next run's weights start afresh
    return runs


KERNEL_GROUPS = (("conv_", "conv_gemm"),
                 ("ConvA", "conv_gemm"),
                 ("selective_scan_kernel", "selective_scan"),
                 ("selective_scan_bwd_kernel", "selective_scan_bwd"),
                 ("flash_bwd_", "flash_bwd"),
                 ("ffip_pair_kernel", "ffip_gemm_y"),
                 ("carry_", "ffip_carry_table"),
                 ("fip_pair_kernel", "fip_gemm"),
                 ("baseline_kernel", "baseline_gemm"),
                 ("baseline_tc", "baseline_gemm"),
                 ("reduce_units", "split-K reduce"),
                 ("flash_fwd_", "flash_fwd"),
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


def ssm_steps(model, params, prompt_len: int = 128):
    """One falcon-mamba prefill of a ``prompt_len``-token prompt (the
    scatter prefill's batch-1 forward) and one decode step over 4 slots."""
    dev = model.device
    cache = model.init_cache(4, 256)
    prompt = torch.zeros((1, prompt_len), dtype=torch.long, device=dev)
    ids = torch.zeros((4, 1), dtype=torch.long, device=dev)
    pos = torch.full((4,), prompt_len, dtype=torch.long, device=dev)
    return {
        "falcon prefill": lambda: model.prefill(
            params, prompt, model.init_cache(1, 256)),
        "falcon decode_step": lambda: model.sample_step(params, ids, cache,
                                                        pos),
    }


def print_profile(steps, want_fn, problems):
    """Profile ``steps`` (FFIP through the kernels) and hold each one's
    launches to ``want_fn(phase)``."""
    for phase, rec in profile(steps).items():
        top = ", ".join(f"{k} {v:.3f}" for k, v in rec["device_ms"].items())
        busy = rec["busy_ms"]
        share = ("not measured" if isinstance(busy, str)
                 else f"{busy / rec['wall_ms']:.3f}")
        scan = rec["device_ms"].get("selective_scan")
        scan_txt = ("" if scan is None or isinstance(busy, str) else
                    f"; selective_scan {scan:.3f} ms ({scan / busy:.4f} of "
                    f"busy)")
        print(f"phase profile {phase} (ffip; LM: 4 slots x 128 / a 64-row "
              f"chunk / one 128-token prompt; vision: batch {CONV_BATCH}): "
              f"wall {rec['wall_ms']:.3f} ms, device busy {busy} ms (share "
              f"{share}){scan_txt}; device ms by kernel: "
              f"{top or 'not measured'}; launches {rec['launches']}",
              flush=True)
        want = want_fn(phase)
        got = {k: rec["launches"][k] for k in want}
        if got != want:
            problems.append(f"{phase} launched {got}, expected {want}")


def run_ssm(args, readings: Readings, problems):
    """falcon-mamba-7b at its published widths through the Mamba1 path:
    served four ways (every prefill layer through K6, the projections
    through K1-K3), tokens held to the plain path (torch.matmul or the plain
    int8 algebra, the plain selective scan), planted faults read, one
    prefill and one decode step profiled. Returns the served runs."""
    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Model

    t0 = time.perf_counter()
    cfg = configs.get_config("falcon-mamba-7b")
    s_cfg = cfg.ssm
    print(f"phase ssm: {cfg.name} d_model {cfg.d_model}, d_inner "
          f"{s_cfg.expand * cfg.d_model}, d_state {s_cfg.d_state}, dt_rank "
          f"{s_cfg.dt_rank}, d_conv {s_cfg.d_conv}, vocab {cfg.vocab}, "
          f"{cfg.param_dtype}, tied; n_layers {cfg.n_layers} (published, "
          f"no cut)", flush=True)
    model = Model(cfg)
    params = model.init(args.seed)
    prompts = served_prompts(cfg.vocab, args.seed)
    print(f"  4 slots, max_len 256, prompt lengths "
          f"{[len(p) for p in prompts]}, {args.max_new} new tokens each; "
          f"weights from seed {args.seed} in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    runs = drive_main_path(model, params, prompts, args.max_new,
                           tag="falcon ")
    gemm = {"ffip": "ffip_gemm_y", "fip": "fip_gemm",
            "baseline": "baseline_gemm"}
    want_scan = cfg.n_layers * len(prompts)
    for r in runs:
        c = r["counts"]
        if not r["budget_ok"]:
            problems.append(f"{r['label']}: a request missed its token budget")
        if c[gemm[r["algo"]]] == 0:
            problems.append(f"{r['label']}: {gemm[r['algo']]} never launched")
        if c["selective_scan"] != want_scan:
            problems.append(f"{r['label']}: selective_scan launched "
                            f"{c['selective_scan']} times, want {want_scan} "
                            f"(one per layer per prompt)")
        if any(c.get(k) for k in ("flash_fwd", "flash_paged", "conv_gemm")):
            problems.append(f"{r['label']}: attention or conv kernels "
                            f"launched {c}")
    print(f"phase ssm serve: {time.perf_counter() - t0:.1f} s", flush=True)

    t1 = time.perf_counter()
    plain = {q: PlainPath(model, params, prompts, q) for q in (False, True)}
    print(f"  plain paths built in {time.perf_counter() - t1:.1f} s",
          flush=True)
    for r in runs:
        tier = "int8" if r["quantized"] else "float"
        readings.read(r["label"], r["done"], plain[r["quantized"]], tier)
        if not r["quantized"]:
            readings.deviation(r["label"], kernel_deviation(
                model, params, prompts, plain[False], r["algo"]))
    label, faulty = wrong_layer(params, "ssm", "out_proj", cfg.n_layers)
    for quantized in (True, False):
        _, done, _ = serve(model, faulty, prompts, max_new=2, batch_slots=4,
                           max_len=256, quantized=quantized, gemm_algo="ffip",
                           gemm_impl="cuda")
        tier = "int8" if quantized else "float"
        readings.read(f"falcon planted fault: {label}, {tier} ffip", done,
                      plain[quantized], tier, fault=True)
    del faulty, plain
    print(f"phase ssm check: {time.perf_counter() - t1:.1f} s", flush=True)

    n = cfg.n_layers
    print_profile(ssm_steps(model, params), lambda phase: {
        "ffip_gemm_y": 4 * n + 1,
        "selective_scan": n if phase == "falcon prefill" else 0}, problems)
    print(f"phase ssm: {time.perf_counter() - t0:.1f} s", flush=True)
    return runs


@contextlib.contextmanager
def plain_recurrence():
    """The Mamba1 mixer's fused scan replaced, while this is open, by
    autograd through the plain f32 recurrence (``ssm._mamba1_scan``): the
    plain side of the falcon gradient reading."""
    from repro_torch.models import ssm

    fused = ssm._selective_scan_fused

    def plain(xs, dt, bmat, cmat, A, h0, chunk, *, trainable=False,
              mesh=None):
        f32 = torch.float32
        no_d = torch.zeros(A.shape[0], dtype=f32, device=A.device)
        y, h = ssm._mamba1_scan(xs.to(f32), dt.to(f32), bmat.to(f32),
                                cmat.to(f32), A, no_d, h0, chunk)
        return y, (None if trainable else h)

    ssm._selective_scan_fused = plain
    try:
        yield
    finally:
        ssm._selective_scan_fused = fused


def _leaf_names(tree, prefix=""):
    """Leaf paths in flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def one_step_grads(model, params, batch):
    """(loss, {leaf path: gradient}) of one training step's loss, on a copy
    of ``params`` (the reference's value_and_grad)."""
    from repro_torch.optim import adamw

    p = adamw.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       params)
    leaves = adamw.tree_leaves(p)
    with torch.enable_grad():
        loss = model.loss(p, batch)
        grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), dict(zip(_leaf_names(p), grads))


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def grad_reading(arch: str, cfg, seed: int, batch_size: int, seq: int):
    """One step's loss and per-stacked-leaf gradient relative L2 error
    through the kernels against the plain path (plain attention, or
    autograd through the plain f32 recurrence) at the first IDENTITY_LAYERS
    layers, same weights and batch; then the same reading of a planted
    fault on the kernel side. Returns (largest sound reading, the fault's
    reading)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model

    n_id = min(IDENTITY_LAYERS, cfg.n_layers)
    cfg_id = dataclasses.replace(cfg, n_layers=n_id)
    model = Model(cfg_id)
    params = model.init(seed)
    data = SyntheticLM(DataConfig(global_batch=batch_size, seq_len=seq,
                                  vocab=cfg.vocab, seed=seed)).batch_at(0)
    batch = {k: torch.from_numpy(v).to(model.device)
             for k, v in data.items()}
    if cfg.family == "ssm":
        plain_model, scope = model, plain_recurrence()
        group, name = "ssm", "out_proj"
    else:
        plain_model = Model(dataclasses.replace(cfg_id,
                                                attention_impl="naive"))
        scope, group, name = contextlib.nullcontext(), "attn", "wo"
    loss_k, g_k = one_step_grads(model, params, batch)
    with scope:
        loss_p, g_p = one_step_grads(plain_model, params, batch)
    sound = {k: _rel_l2(g_k[k], g_p[k]) for k in g_p}
    del g_k
    label, faulty = wrong_layer(params, group, name, n_id)
    loss_f, g_f = one_step_grads(model, faulty, batch)
    fault = {k: _rel_l2(g_f[k], g_p[k]) for k in g_p}
    top = max(sound, key=sound.get)
    worst = max(fault, key=fault.get)
    print(f"  [{arch} gradients, {n_id} layers, batch {batch_size} x {seq}] "
          f"loss through the kernels {loss_k:.6f}, plain {loss_p:.6f} "
          f"(rel {abs(loss_k - loss_p) / abs(loss_p):.3g}); per-leaf "
          f"relative L2 error of the gradients: largest {sound[top]:.4g} "
          f"({top}); all: "
          f"{', '.join(f'{k} {v:.3g}' for k, v in sound.items())}",
          flush=True)
    print(f"  [{arch} planted fault: {label}] loss {loss_f:.6f}; largest "
          f"per-leaf gradient error {fault[worst]:.4g} ({worst})", flush=True)
    del g_p, g_f, params, faulty, model, plain_model
    return sound[top], fault[worst]


TRAIN_OTHER_KERNELS = ("baseline_gemm", "fip_gemm", "ffip_gemm_y",
                       "flash_paged", "conv_gemm")


def profile_train_step(model, out, tcfg, batch):
    """Device time by kernel of one more training step (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from repro_torch.train.step import make_train_step

    step_fn = make_train_step(model, tcfg)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(out["params"], out["opt_state"], batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: an operator's device time is also its kernels', and
    # autograd's backward thread makes the two overlap
    device_ms: dict = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = (getattr(ev, "self_device_time_total", 0)
              or getattr(ev, "device_time_total", 0) or 0)
        if us > 0:
            g = _group(ev.key)
            device_ms[g] = device_ms.get(g, 0.0) + us / 1e3
    busy = sum(device_ms.values())
    top = ", ".join(f"{k} {v:.2f}" for k, v in sorted(
        device_ms.items(), key=lambda kv: -kv[1])[:8])
    share = f"{busy / wall_ms:.3f}" if busy else "not measured"
    print(f"  profiled step: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms (share {share}); device ms by kernel: "
          f"{top or 'not measured'}", flush=True)
    return dict(wall_ms=wall_ms, busy_ms=busy, device_ms=device_ms)


def run_train(args, problems):
    """Train minicpm-2b and falcon-mamba-7b at full width (TRAIN_RUNS)
    through ``train.loop.train``: AdamW with the launcher's minicpm choice
    (WSD, 2 warmup steps over 8), batches from the port's pipeline. Every
    step must launch K4 and K8 (K6 and K9) once per layer and nothing else
    of the kernels; losses and gradient norms finite; the last loss below
    the first. Then the gradient readings, and for attention models the lr
    witness. Returns (records, readings)."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import compat
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.step import TrainConfig

    records, readings = [], []
    for arch, n_layers, batch_size, seq in TRAIN_RUNS:
        t0 = time.perf_counter()
        full = configs.get_config(arch)
        cfg = dataclasses.replace(full, n_layers=n_layers)
        model = Model(cfg)
        n_params = cfg.param_count()
        print(f"phase train: {arch} d_model {cfg.d_model}, vocab "
              f"{cfg.vocab}, {cfg.param_dtype}; n_layers {n_layers} "
              f"(published {full.n_layers}), {n_params / 1e9:.2f} B params; "
              f"batch {batch_size} x seq {seq}, {TRAIN_STEPS} AdamW steps "
              f"(lr {TRAIN_LR}, WSD, warmup 2), weights from seed "
              f"{args.seed}", flush=True)
        if cfg.family == "ssm":
            want = {"selective_scan": n_layers, "selective_scan_bwd": n_layers,
                    "flash_fwd": 0, "flash_bwd": 0}
        else:
            want = {"flash_fwd": n_layers, "flash_bwd": n_layers,
                    "selective_scan": 0, "selective_scan_bwd": 0}
        want.update({k: 0 for k in TRAIN_OTHER_KERNELS})
        marks = []

        def log(m):
            marks.append((time.perf_counter(), compat.launch_counts(), m))

        tcfg = TrainConfig(optimizer=AdamWConfig(
            lr=TRAIN_LR, schedule="wsd", warmup_steps=2,
            total_steps=TRAIN_STEPS))
        torch.cuda.reset_peak_memory_stats()
        compat.reset_counters()
        t_start = time.perf_counter()
        out = train(model, loop_cfg=LoopConfig(
            total_steps=TRAIN_STEPS, global_batch=batch_size, seq_len=seq,
            log_every=1, seed=args.seed), train_cfg=tcfg, log_fn=log)
        counts = compat.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        times = [marks[0][0] - t_start] + [b[0] - a[0] for a, b in
                                           zip(marks, marks[1:])]
        prev: dict = {}
        per_step = []
        for _, c, _ in marks:
            per_step.append({k: c.get(k, 0) - prev.get(k, 0) for k in want})
            prev = c
        bad_steps = [i for i, c in enumerate(per_step) if c != want]
        hist = out["history"]
        losses = [h["loss"] for h in hist]
        norms = [h["grad_norm"] for h in hist]
        finite = all(np.isfinite(losses)) and all(np.isfinite(norms))
        falls = losses[-1] < losses[0]
        steady = times[1:]
        ms_step = 1e3 * sum(steady) / len(steady)
        tok_s = batch_size * seq / (ms_step / 1e3)
        lrs = ", ".join(f"{h['lr']:.3g}" for h in hist)
        print(f"  losses {[round(v, 4) for v in losses]}; grad norms "
              f"{[round(v, 3) for v in norms]}; lr [{lrs}]", flush=True)
        step_ms = [round(1e3 * t, 1) for t in times]
        print(f"  [{arch} train] {len(hist)} steps, finite {finite}, last "
              f"loss below the first {falls}; step ms {step_ms} (the first "
              f"includes init and first use); "
              f"{ms_step:.1f} ms/step over steps 2-{TRAIN_STEPS}, "
              f"{tok_s:.0f} tokens/s; peak memory {peak:.2f} GiB; launches "
              f"per step {per_step[0]} (every step as wanted: "
              f"{not bad_steps}); total {counts}", flush=True)
        if not finite:
            problems.append(f"{arch} train: a loss or gradient norm is not "
                            f"finite")
        if not falls:
            problems.append(f"{arch} train: the last loss {losses[-1]} is not "
                            f"below the first {losses[0]}")
        if bad_steps or len(marks) != TRAIN_STEPS:
            problems.append(f"{arch} train: steps {bad_steps} launched "
                            f"{[per_step[i] for i in bad_steps]}, want {want}")
        data = SyntheticLM(DataConfig(global_batch=batch_size, seq_len=seq,
                                      vocab=cfg.vocab, seed=args.seed))
        batch = {k: torch.from_numpy(v).to(model.device)
                 for k, v in data.batch_at(TRAIN_STEPS).items()}
        prof = profile_train_step(model, out, tcfg, batch)
        records.append(dict(arch=arch, n_layers=n_layers, batch=batch_size,
                            seq=seq, losses=losses, grad_norms=norms,
                            step_s=times, ms_per_step=ms_step,
                            tokens_per_s=tok_s, peak_gib=peak,
                            counts=counts, profile=prof))
        del out, model, batch
        free_device()
        readings.append((arch, *grad_reading(arch, cfg, args.seed,
                                             batch_size, seq)))
        free_device()
        if cfg.family != "ssm":
            lr_witness(arch, cfg, args.seed, batch_size, seq, problems)
            free_device()
        print(f"phase train {arch}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    sound = max(r[1] for r in readings)
    fault = min(r[2] for r in readings)
    print(f"  gradient bar {GRAD_BAR}: largest sound reading {sound:.4g}; "
          f"smallest reading of a planted fault {fault:.4g}", flush=True)
    if not sound < GRAD_BAR < fault:
        problems.append(f"the gradient bar {GRAD_BAR} does not lie between "
                        f"its sound readings (up to {sound:.4g}) and its "
                        f"planted faults (from {fault:.4g})")
    return records, readings


def lr_witness(arch: str, cfg, seed: int, batch_size: int, seq: int,
               problems):
    """Train ``cfg`` for TRAIN_STEPS steps at AdamWConfig's default learning
    rate (WSD, 2 warmup steps), through the kernels and through the plain
    path (attention_impl="naive"), from the same weights and batches, and
    print both losses step by step. Where the plain path's last loss falls
    below its first and the kernels' does not, the kernels are at fault."""
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.step import TrainConfig

    opt = AdamWConfig(schedule="wsd", warmup_steps=2, total_steps=TRAIN_STEPS)
    losses = {}
    for impl in ("flash", "naive"):
        model = Model(dataclasses.replace(cfg, attention_impl=impl))
        out = train(model, loop_cfg=LoopConfig(
            total_steps=TRAIN_STEPS, global_batch=batch_size, seq_len=seq,
            log_every=1, seed=seed), train_cfg=TrainConfig(optimizer=opt),
            log_fn=lambda m: None)
        losses[impl] = [h["loss"] for h in out["history"]]
        del out, model
        free_device()
    kern, plain = losses["flash"], losses["naive"]
    rel = [abs(a - b) / abs(b) for a, b in zip(kern, plain)]
    print(f"  [{arch} lr witness, lr {opt.lr}] losses through the kernels "
          f"{[round(v, 4) for v in kern]}; plain path "
          f"{[round(v, 4) for v in plain]}; relative difference by step "
          f"{[float(f'{r:.3g}') for r in rel]}; last loss below the first: "
          f"kernels {kern[-1] < kern[0]}, plain {plain[-1] < plain[0]}",
          flush=True)
    if plain[-1] < plain[0] and not kern[-1] < kern[0]:
        problems.append(f"{arch} lr witness: at lr {opt.lr} the plain path's "
                        f"loss falls ({plain[0]} -> {plain[-1]}) and the "
                        f"kernels' does not ({kern[0]} -> {kern[-1]})")


def free_device():
    from repro_torch.kernels import compat
    compat.derived.clear()
    torch.cuda.empty_cache()


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
    recs = check_gemms(dev)
    recs += (check_flash(dev) + check_paged(dev)
            + check_convs(dev) + check_scan(dev, [
                len(p) for p in served_prompts(
                    configs.get_config("falcon-mamba-7b").vocab,
                    args.seed)])
            + check_flash_bwd(dev) + check_scan_bwd(dev))
    bad = [r for r in recs if not r["ok"]]
    print(f"phase kernels: {len(recs)} checks, {len(bad)} failed, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if bad:
        print(f"FAIL: kernels disagree with their plain versions: {bad}",
              file=sys.stderr)
        return 1
    free_device()
    t0 = time.perf_counter()
    print("phase invariance: a row's bits must not depend on the rows "
          "beside it", flush=True)
    varying = check_batch_invariance(dev)
    print(f"phase invariance: {time.perf_counter() - t0:.1f} s", flush=True)
    if varying:
        print(f"FAIL: results depend on the batch: {varying}",
              file=sys.stderr)
        return 1
    free_device()

    # 3. minicpm-2b served at full width, contiguous cache
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
    prompts = served_prompts(cfg.vocab, args.seed)
    runs = drive_main_path(model, params, prompts, args.max_new)
    expect = {"ffip": "ffip_gemm_y", "fip": "fip_gemm",
              "baseline": "baseline_gemm"}
    problems = [f"{r['label']}: {expect[r['algo']]} never launched"
                for r in runs if r["counts"][expect[r["algo"]]] == 0]
    problems += [f"{r['label']}: a request missed its token budget"
                 for r in runs if not r["budget_ok"]]
    print(f"phase serve: {time.perf_counter() - t0:.1f} s", flush=True)

    # 4. first and second tokens against the plain path, and the bars'
    # witnesses: an int8 run without the flash kernel (held to
    # PLAIN_ATTENTION_BAR_SD), and served runs with planted faults
    t0 = time.perf_counter()
    readings = Readings(problems)
    plain = {q: PlainPath(model, params, prompts, q) for q in (False, True)}
    print(f"  plain paths built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for r in runs:
        readings.read(r["label"], r["done"], plain[r["quantized"]],
                      "int8" if r["quantized"] else "float")
        if not r["quantized"]:
            readings.deviation(r["label"], kernel_deviation(
                model, params, prompts, plain[False], r["algo"]))
    # plain attention on both sides: only the GEMM kernels and the batching
    # differ
    _, done, _ = serve(naive, params, prompts, max_new=2, batch_slots=4,
                       max_len=256, quantized=True, gemm_algo="ffip",
                       gemm_impl="cuda")
    worst = readings.read("int8-ffip, plain attention", done, plain[True],
                          "int8")
    if worst > PLAIN_ATTENTION_BAR_SD:
        problems.append(f"int8-ffip with plain attention reads {worst:.4f} "
                        f"sd, above {PLAIN_ATTENTION_BAR_SD}")
    for label, faulty in int8_step_faults(params, cfg.n_layers).items():
        _, done, _ = serve(model, faulty, prompts, max_new=2, batch_slots=4,
                           max_len=256, quantized=True, gemm_algo="ffip",
                           gemm_impl="cuda")
        readings.read(f"planted fault: {label}", done, plain[True], "int8",
                      fault=True, gated=False)
    label, faulty = wrong_layer(params, "attn", "wo", cfg.n_layers)
    for quantized in (True, False):
        _, done, _ = serve(model, faulty, prompts, max_new=2, batch_slots=4,
                           max_len=256, quantized=quantized, gemm_algo="ffip",
                           gemm_impl="cuda")
        tier = "int8" if quantized else "float"
        readings.read(f"planted fault: {label}, {tier} ffip", done,
                      plain[quantized], tier, fault=True)
    del faulty, plain
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
    readings.read(ffip["label"], ffip["done"], plain[False], "float")
    readings.read(int8["label"], int8["done"], plain[True], "int8")
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
    # the vision, SSM and training paths
    elsewhere = ("conv_gemm", "selective_scan", "flash_bwd",
                 "selective_scan_bwd")
    problems += [f"{name} never launched on the served path"
                 for name, n in totals.items()
                 if n == 0 and name not in elsewhere]
    problems += [f"{name} launched {totals[name]} times on the minicpm paths"
                 for name in elsewhere if totals[name]]
    print(f"launches over the minicpm served runs {totals}", flush=True)

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

    # 7. one dispatch of each kind, counted and profiled. LM: 7 projections
    # per layer plus the unembed; attention once per layer: K4 in the
    # contiguous prefill, K5 in either paged dispatch. Vision: K7 for each
    # of the 53 convs, K3 for the FC.
    steps = contiguous_steps(model, params, 128)
    steps.update(paged_steps(model, params))
    steps["resnet50 forward"] = vision_step(dev, args.seed)
    print_profile(steps, lambda phase: (
        {"conv_gemm": 53, "ffip_gemm_y": 1}
        if phase == "resnet50 forward" else
        {"ffip_gemm_y": 7 * cfg.n_layers + 1,
         "flash_fwd": cfg.n_layers if phase == "prefill" else 0,
         "flash_paged": cfg.n_layers if "paged" in phase else 0}), problems)
    del steps, model, params, naive, model_id, naive_id, params_id
    free_device()

    # 8. the Mamba1 path: falcon-mamba-7b through K6 and K1-K3
    ssm_runs = run_ssm(args, readings, problems)
    totals["selective_scan"] = sum(r["counts"]["selective_scan"]
                                   for r in ssm_runs)
    for name in ("baseline_gemm", "fip_gemm", "ffip_gemm_y",
                 "ffip_carry_table"):
        totals[name] += sum(r["counts"][name] for r in ssm_runs)
    free_device()

    # 9. the training path: minicpm-2b through K4 + K8, falcon-mamba-7b
    # through K6 + K9, and the gradient readings
    t0 = time.perf_counter()
    train_recs, _ = run_train(args, problems)
    for name in ("flash_fwd", "flash_bwd", "selective_scan",
                 "selective_scan_bwd"):
        totals[name] += sum(r["counts"][name] for r in train_recs)
    print(f"phase train: {time.perf_counter() - t0:.1f} s", flush=True)
    readings.gate()
    if problems:
        print("FAIL:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1

    # 10. the kernels line and the result line
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
        elif name == "selective_scan":
            head = next(r for r in recs_k if r["case"] == HEADLINE_SCAN)
            shape = (f"B={head['b']} S={head['s']} di={head['di']} "
                     f"N={head['n']} chunk {head['chunk']} bf16, falcon "
                     f"prefill; library: none (no PyTorch call computes a "
                     f"selective scan)")
        elif name == "flash_bwd":
            head = next(r for r in recs_k if (r["case"], r["dtype"])
                        == HEADLINE_FLASH_BWD)
            shape = (f"BH={head['bh']} S={head['s']} d={head['d']} causal "
                     f"bf16, minicpm-2b training; ms by CUDA-graph replay; "
                     f"library: aten._scaled_dot_product_"
                     f"{head['library_op']} on its forward's saved outputs, "
                     f"by CUDA-graph replay")
        elif name == "selective_scan_bwd":
            head = next(r for r in recs_k if r["case"] == HEADLINE_SCAN_BWD)
            shape = (f"B={head['b']} S={head['s']} di={head['di']} "
                     f"N={head['n']} chunk {head['chunk']} f32, falcon-mamba "
                     f"training; library: none (no PyTorch call computes a "
                     f"selective-scan backward)")
        elif name == "ffip_carry_table":
            _, k, n, dt = HEADLINE_GEMM
            head = next(r for r in recs_k if (r["k"], r["n"], r["dtype"])
                        == (k, n, dt))
            shape = (f"y K={k} N={n} f32 (of {dt} weights) -> ({k}, "
                     f"{-(-n // 32)}), once per weight, memoized beside y; "
                     f"library: torch.cumsum(y, 1)")
        elif name == "flash_fwd":
            head = next(r for r in recs_k if (r["case"], r["dtype"])
                        == HEADLINE_FLASH)
            shape = (f"BH={head['bh']} S={head['s']} d={head['d']} causal "
                     f"bf16, minicpm-2b prefill; ms by CUDA-graph replay; "
                     f"library: scaled_dot_product_attention, by CUDA-graph "
                     f"replay")
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
