"""Offline kernel autotuner CLI: fills the ``repro_torch.tune`` schedule
cache. Counterpart of ``repro/launch/tune.py``; runs on the card unless
``--device cpu`` is given.

    # the GEMM shapes of a model config (every dense projection and the
    # tied unembed) at the M values given, and its flash buckets:
    python -m repro_torch.launch.tune --arch minicpm-2b --m 4,512 \\
        --dtypes bfloat16,int8

    # a CNN workload's conv-as-GEMM shape table (core.workloads):
    python -m repro_torch.launch.tune --workload alexnet --dtypes int8

Shapes are bucketed (pow2 a dim) and deduplicated before measuring, so a
run costs one tuning a distinct bucket. A warm cache is a no-op: tuned
buckets are reported as ``cached`` with no measurement, and
``--expect-cached`` makes that an assertion (a second run must measure
nothing). Serving reads the schedules through ``--gemm-block auto``
(``launch.serve``, ``BatchServer``) and ``GemmConfig(block="auto")``. K7's
schedules are tuned at their real conv geometry by ``python -m
repro_torch.launch.vision --model X --tune``.

``--refresh-artifact DIR`` re-slices a ``repro_torch.prepare`` artifact's
schedule from the cache for this device and saves it again.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Tuple

import torch

from repro_torch import configs, tune
from repro_torch.core import workloads
from repro_torch.tune import measure

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


def _arch_gemm_shapes(cfg, m_values: List[int]) -> List[Tuple[int, int, int]]:
    """(m, k, n) set of a model config: every dense ``w`` leaf of the
    port's own parameter tree, built on the meta device (leading stacked
    dims stripped), plus a tied embedding's unembed, crossed with the M
    values (tokens a dispatch: decode = slots, prefill = slots x bucket)."""
    from repro_torch.models import transformer as T
    params = T.init_params(torch.Generator(), cfg, device="meta")
    kn: set = set()

    def walk(node):
        if isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, torch.Tensor) and w.dim() >= 2:
                kn.add((int(w.shape[-2]), int(w.shape[-1])))
            tbl = node.get("table")
            if isinstance(tbl, torch.Tensor) and tbl.dim() == 2:
                kn.add((int(tbl.shape[1]), int(tbl.shape[0])))  # d -> V
            for v in node.values():
                walk(v)

    walk(params)
    return [(m, k, n) for m in m_values for (k, n) in sorted(kn)]


def _workload_gemm_shapes(name: str, batch: int) -> List[Tuple[int, int, int]]:
    return [(g.m, g.k, g.n) for g in workloads.MODELS[name](batch)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="pre-populate the repro_torch.tune schedule cache")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--arch", choices=sorted(configs.ARCHS))
    src.add_argument("--workload", choices=sorted(workloads.MODELS))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config for --arch")
    ap.add_argument("--batch", type=int, default=1, help="--workload batch")
    ap.add_argument("--m", default="4,64,256",
                    help="comma-separated M values (tokens a dispatch) "
                         "crossed with the --arch (K, N) set")
    ap.add_argument("--slots", default="2,4",
                    help="comma-separated serving batch sizes for the --arch "
                         "flash buckets (prefill runs BH = slots x heads)")
    ap.add_argument("--seq", default="16,64",
                    help="comma-separated sequence lengths (prompt buckets) "
                         "for the --arch flash-attention jobs")
    ap.add_argument("--algos", default="baseline,fip,ffip")
    ap.add_argument("--dtypes", default="float32,int8",
                    help="comma-separated of float32, bfloat16, int8")
    ap.add_argument("--budget", type=int, default=0,
                    help="max candidates a bucket (0 = the whole space)")
    ap.add_argument("--iters", type=int, default=3,
                    help="timed replays a candidate (the median wins)")
    ap.add_argument("--limit", type=int, default=0,
                    help="cap the number of distinct buckets tuned (0 = all)")
    ap.add_argument("--no-flash", action="store_true",
                    help="skip flash-attention tuning for --arch")
    ap.add_argument("--expect-cached", action="store_true",
                    help="fail if anything had to be measured (a warm-cache "
                         "assertion)")
    ap.add_argument("--refresh-artifact", default=None, metavar="DIR",
                    help="after tuning, re-slice this repro_torch.prepare "
                         "artifact's schedule from the cache and re-save it")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda:0); 'cpu' times the "
                         "plain versions (for tests)")
    args = ap.parse_args(argv)

    m_values = [int(x) for x in args.m.split(",") if x]
    algos = [a for a in args.algos.split(",") if a]
    try:
        dtypes = [_DTYPES[d] for d in args.dtypes.split(",") if d]
    except KeyError as e:
        ap.error(f"--dtypes: unknown dtype {e} (have {sorted(_DTYPES)})")
    from repro_torch.kernels import compat
    device = compat.resolve_device(args.device)

    flash_jobs: List[Tuple[int, int, int, int]] = []
    if args.arch:
        cfg = configs.get_config(args.arch)
        if args.smoke:
            cfg = configs.smoke_config(cfg)
        shapes = _arch_gemm_shapes(cfg, m_values)
        if not args.no_flash:
            # the q/k head dim flash sees: MLA's prefill runs it on the
            # decompressed nope + rope heads, everything else on cfg.hd;
            # keyed on the serving geometry, BH = slots x heads and
            # sq = sk = the prompt bucket
            hd = (cfg.mla.nope_head_dim + cfg.mla.rope_head_dim
                  if cfg.mla is not None else cfg.hd)
            flash_jobs = [(cfg.n_heads * b, s, s, hd)
                          for b in (int(x) for x in args.slots.split(",") if x)
                          for s in (int(x) for x in args.seq.split(",") if x)]
        flash_dtype = cfg.dtype
        label = cfg.name
    else:
        shapes = _workload_gemm_shapes(args.workload, args.batch)
        flash_dtype = torch.float32
        label = args.workload

    cache = tune.get_cache()
    timed0 = measure.counters["timed_candidates"]
    seen, jobs = set(), []
    for (m, k, n) in shapes:
        for algo in algos:
            for dt in dtypes:
                key = tune.gemm_key(algo, dt, m, n, k)
                if key not in seen:
                    seen.add(key)
                    jobs.append((key, m, k, n, algo, dt))
    if args.limit:
        # one cap over GEMM + flash buckets together (GEMM jobs first)
        jobs = jobs[:args.limit]
        flash_jobs = flash_jobs[:max(0, args.limit - len(jobs))]

    t0 = time.perf_counter()
    measured = cached = 0
    for key, m, k, n, algo, dt in jobs:
        pre = measure.counters["timed_candidates"]
        entry = tune.tune_gemm(m, n, k, dt, algo=algo, budget=args.budget,
                               iters=args.iters, device=device, cache=cache,
                               persist=False)
        fresh = measure.counters["timed_candidates"] > pre
        measured += fresh
        cached += not fresh
        b = entry["blocks"]
        status = "tuned " if fresh else "cached"
        print(f"[{status}] gemm {algo:8s} {tune._dtype_name(dt):8s} "
              f"m{m} k{k} n{n} -> bm={b['bm']} bn={b['bn']} bk={b['bk']} "
              f"({entry['us']}us, default {entry['default_us']}us, "
              f"{entry['candidates']} candidates)")

    flash_seen: set = set()
    for bh, sq, sk, d in flash_jobs:
        fkey = tune.flash_key(flash_dtype, bh, sq, sk, d)
        if fkey in flash_seen:       # slot counts sharing a pow2 BH bucket
            continue
        flash_seen.add(fkey)
        pre = measure.counters["timed_candidates"]
        entry = tune.tune_flash(bh, sq, sk, d, flash_dtype,
                                budget=args.budget, iters=args.iters,
                                device=device, cache=cache, persist=False)
        fresh = measure.counters["timed_candidates"] > pre
        measured += fresh
        cached += not fresh
        b = entry["blocks"]
        status = "tuned " if fresh else "cached"
        print(f"[{status}] flash fwd {tune._dtype_name(flash_dtype)} "
              f"bh{bh} sq{sq} sk{sk} d{d} -> bq={b['bq']} bk={b['bk']} "
              f"({entry['us']}us)")

    if measured:
        cache.save()   # one write for the whole sweep, not one a bucket
    dt_s = time.perf_counter() - t0
    timed = measure.counters["timed_candidates"] - timed0
    print(f"{label}: {measured} buckets tuned / {cached} reused from cache "
          f"({timed} candidates timed, {dt_s:.1f}s) -> {cache.path}")
    if args.expect_cached and measured:
        print("--expect-cached: FAIL, a warm cache still measured",
              file=sys.stderr)
        return 1
    if args.refresh_artifact:
        from repro_torch import prepare
        pm = prepare.load(args.refresh_artifact, map_location=device)
        # re-slice for THIS device (the one just tuned on) and re-stamp:
        # also the way to re-home an artifact whose slice was dropped on a
        # foreign device kind
        pm.device = compat.device_kind()
        pm.schedule = cache.entries_for_device(pm.device)
        pm.save(args.refresh_artifact)
        print(f"refreshed {args.refresh_artifact}: "
              f"{len(pm.schedule)} schedule entries for {pm.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
