#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, in order; any failure exits non-zero and prints no result line:

1. Print the card's name and power limit (``nvidia-smi``), then build every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all started together) and print the build time.
2. Hold each kernel against its plain PyTorch version at the main path's
   shapes: the GEMMs K1-K3 at M in {4, 512} x (K, N) in {(2304, 2304),
   (2304, 5760), (5760, 2304), (2304, 122753)}, in bf16 (beta unfolded) and
   int8 (beta folded, as the int8 dense layer calls them); the flash kernel
   K4 at BH = 4 x 36, d = 64, causal, over the prefill buckets S in {16, 32,
   64, 128}. Tolerances: int8 exact; bf16 GEMMs the reference's f32 GEMM bar
   (rtol 1e-4, atol 1e-3 * max(1, K // 64)), both sides summing the same
   products in f32 in another order; flash o at 2**-7 (one bf16 rounding of
   o) and lse at 2e-3. Each call is timed with CUDA events, L2 flushed
   between launches, beside its plain version, its library yardstick and its
   bound.
3. Serve minicpm-2b at its published widths (random weights from --seed)
   through ``BatchServer(gemm_impl="cuda")``: 4 slots, 8 requests of 16-128
   prompt tokens, 16 new tokens each, once each with gemm_algo ffip, fip and
   baseline and once int8 (quantized, ffip). Launch counts are zeroed just
   before each run and read just after. Every request must complete with its
   exact budget.
4. Check the tokens against the plain path (torch.matmul / the plain int8
   algebra, plain attention, one prompt at a time): each served first token
   against a plain prefill of its prompt, each second token against a plain
   decode step fed the served first token. A token must be the plain argmax
   or within a bar of standard deviations of the plain logits' max
   (FLOAT_BAR_SD, INT8_BAR_SD). The int8 bar is held between readings
   taken in the same run: the int8 run once more with plain attention (no
   flash kernel; it must pass the float bar) and int8 runs with planted
   faults (each must fail the int8 bar).
5. Count and profile one prefill dispatch and one decode step.
6. Print the kernels line (JSON), then the result line.
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
}
SOURCES = {
    "baseline_gemm": "src/repro_torch/kernels/csrc/baseline_gemm.cu",
    "fip_gemm": "src/repro_torch/kernels/csrc/fip_gemm.cu",
    "ffip_gemm_y": "src/repro_torch/kernels/csrc/ffip_gemm.cu",
    "flash_fwd": "src/repro_torch/kernels/csrc/flash_fwd.cu",
}

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
                    want = plain()
                    torch.cuda.synchronize()
                    abs_err, rel_err = _err(got, want)
                    if dtype == "int8":
                        ok, tol = torch.equal(got, want), "exact"
                    else:
                        atol = 1e-3 * max(1, k // 64)
                        ok = _allclose(got, want, 1e-4, atol)
                        tol = f"rtol 1e-4 atol {atol:g}"
                    one = time_ms(kern, 1)
                    ms = time_ms(kern, reps_for(one), warm=False)
                    plain_ms = time_ms(plain, 1, warm=False)
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
        o_ref, lse_ref = _flash_fwd_plain(q, k, v, 0, causal=True)
        torch.cuda.synchronize()
        o_err, _ = _err(o, o_ref)
        lse_err, _ = _err(lse, lse_ref)
        ok = (_allclose(o, o_ref, 2 ** -7, 2 ** -7)
              and _allclose(lse, lse_ref, 2e-3, 2e-3))
        kern = lambda: _flash_fwd(q, k, v, 0, causal=True)      # noqa: E731
        plain = lambda: _flash_fwd_plain(q, k, v, 0, causal=True)  # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(           # noqa: E731
            q[None], k[None], v[None], is_causal=True)
        ms = time_ms(kern, 20)
        plain_ms = time_ms(plain, 3)
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
        the cache's last, rewritten by each call)."""
        tok = torch.tensor([[first_tok]], device=self.model.device)
        with self._scope():
            _, logits = self.model.decode_step(self.params, tok,
                                               self.caches[rid],
                                               self.lens[rid])
        return logits[0].float()


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


KERNEL_GROUPS = (("ffip_kernel", "ffip_gemm_y"), ("fip_kernel", "fip_gemm"),
                 ("baseline_kernel", "baseline_gemm"),
                 ("reduce_splits", "split-K reduce"),
                 ("flash_fwd_kernel", "flash_fwd"))


def _group(kernel_name: str) -> str:
    for key, group in KERNEL_GROUPS:
        if key in kernel_name:
            return group
    return "torch ops"


def profile_dispatches(model, params, prompt_len: int):
    """One bucketed prefill dispatch (4 slots x ``prompt_len``) and one
    decode step under FFIP through the kernels: launches counted, host wall
    time, and device time by kernel from ``torch.profiler`` (busy = the sum
    of kernel times; "not measured" where the profiler saw no device
    activity)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.gemm import GemmConfig, use_gemm
    from repro_torch.kernels import compat

    dev = model.device
    cache = model.init_cache(4, 256)
    tokens = torch.zeros((4, prompt_len), dtype=torch.long, device=dev)
    lengths = torch.full((4,), prompt_len, dtype=torch.long, device=dev)
    mask = torch.ones((4,), dtype=torch.bool, device=dev)
    pos = torch.full((4,), prompt_len, dtype=torch.long, device=dev)
    steps = {
        "prefill": lambda: model.prefill_sample(params, tokens, cache,
                                                lengths, mask),
        "decode_step": lambda: model.sample_step(params, tokens[:, :1],
                                                 cache, pos),
    }
    out = {}
    with use_gemm(GemmConfig(algo="ffip", impl="cuda")), torch.no_grad(), \
            compat.use_derived(compat.DerivedCache()):
        for phase, fn in steps.items():
            fn()
            torch.cuda.synchronize()
            compat.reset_counters()
            with profile(activities=[ProfilerActivity.CPU,
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
    bad = [r for r in gemm_recs + flash_recs if not r["ok"]]
    print(f"phase kernels: {len(gemm_recs) + len(flash_recs)} checks, "
          f"{len(bad)} failed, {time.perf_counter() - t0:.1f} s", flush=True)
    if bad:
        print(f"FAIL: kernels disagree with their plain versions: {bad}",
              file=sys.stderr)
        return 1
    compat.derived.clear()
    torch.cuda.empty_cache()

    # 3. the main path: minicpm-2b served at full width
    t0 = time.perf_counter()
    full = configs.get_config("minicpm-2b")
    cfg = dataclasses.replace(full, n_layers=args.layers)
    print(f"phase serve: {cfg.name} d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}x{cfg.hd} (kv {cfg.n_kv_heads}), d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.param_dtype}; n_layers {cfg.n_layers} "
          f"(published {full.n_layers})", flush=True)
    model = Model(cfg)
    params = model.init(args.seed)
    prompts = make_prompts(cfg.vocab, 8, np.random.default_rng(args.seed),
                           16, 129)
    runs = drive_main_path(model, params, prompts, args.max_new)
    totals = {name: sum(r["counts"][name] for r in runs)
              for name in compat.launch_counts()}
    expect = {"ffip": "ffip_gemm_y", "fip": "fip_gemm",
              "baseline": "baseline_gemm"}
    problems = [f"{r['label']}: {expect[r['algo']]} never launched"
                for r in runs if r["counts"][expect[r["algo"]]] == 0]
    problems += [f"{name} never launched on the main path"
                 for name, n in totals.items() if n == 0]
    problems += [f"{r['label']}: a request missed its token budget"
                 for r in runs if not r["budget_ok"]]
    print(f"phase serve: {time.perf_counter() - t0:.1f} s; launches over the "
          f"served runs {totals}", flush=True)

    # 4. first and second tokens against the plain path; for int8, the
    # readings that set its bar: a served run without the flash kernel, and
    # served runs with planted faults
    t0 = time.perf_counter()
    plain = {q: PlainPath(model, params, prompts, q) for q in (False, True)}

    def read(label, done, quantized, bar, must_pass=True):
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
                     INT8_BAR_SD if r["quantized"] else FLOAT_BAR_SD)
        if r["quantized"]:
            sound[r["label"]] = worst
    # the int8 run once more without the flash kernel: plain attention on
    # both sides, so only the GEMM kernels and the batching differ
    naive = Model(dataclasses.replace(cfg, attention_impl="naive"))
    _, done, _ = serve(naive, params, prompts, max_new=2, batch_slots=4,
                       max_len=256, quantized=True, gemm_algo="ffip",
                       gemm_impl="cuda")
    sound["int8-ffip, plain attention"] = read(
        "int8-ffip, plain attention", done, True, FLOAT_BAR_SD)
    seen = {}
    for label, (faulty, must_see) in planted_faults(
            params, cfg.n_layers).items():
        _, done, _ = serve(model, faulty, prompts, max_new=2, batch_slots=4,
                           max_len=256, quantized=True, gemm_algo="ffip",
                           gemm_impl="cuda")
        worst = read(f"planted fault: {label}", done, True, INT8_BAR_SD,
                     must_pass=False)
        if must_see:
            seen[label] = worst
    print(f"  int8 bar {INT8_BAR_SD} sd: largest sound reading "
          f"{max(sound.values()):.4f}, smallest reading of a planted fault "
          f"the bar must see {min(seen.values()):.4f}", flush=True)
    problems += [f"planted fault not seen by the int8 bar: {label}"
                 for label, w in seen.items() if w <= INT8_BAR_SD]
    del plain
    print(f"phase check: {time.perf_counter() - t0:.1f} s", flush=True)
    if problems:
        print("FAIL:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1

    # 5. one prefill dispatch and one decode step, counted and profiled
    for phase, rec in profile_dispatches(model, params, 128).items():
        top = ", ".join(f"{k} {v:.3f}" for k, v in rec["device_ms"].items())
        print(f"phase profile {phase} (ffip, 4 slots x 128): wall "
              f"{rec['wall_ms']:.3f} ms, device busy {rec['busy_ms']} ms; "
              f"device ms by kernel: {top or 'not measured'}; launches "
              f"{rec['launches']}", flush=True)
        # 7 projections per layer plus the unembed; flash once per layer
        # in prefill only
        want = {"ffip_gemm_y": 7 * cfg.n_layers + 1,
                "flash_fwd": cfg.n_layers if phase == "prefill" else 0}
        got = {k: rec["launches"][k] for k in want}
        if got != want:
            print(f"FAIL: {phase} launched {got}, expected {want}",
                  file=sys.stderr)
            return 1

    # 6. the kernels line and the result line
    kernels = []
    for name in ("baseline_gemm", "fip_gemm", "ffip_gemm_y", "flash_fwd"):
        recs = [r for r in gemm_recs + flash_recs if r["kernel"] == name]
        if name == "flash_fwd":
            head = next(r for r in recs if r["s"] == HEADLINE_FLASH_S)
            shape = f"BH={head['bh']} S={head['s']} d={head['d']} causal bf16"
        else:
            m, k, n, dt = HEADLINE_GEMM
            head = next(r for r in recs if (r["m"], r["k"], r["n"],
                                            r["dtype"]) == (m, k, n, dt))
            shape = f"M={m} K={k} N={n} {dt}"
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": totals[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": shape,
            "per_shape": [{k: v for k, v in r.items()
                           if k not in ("kernel", "ok")} for r in recs]})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
