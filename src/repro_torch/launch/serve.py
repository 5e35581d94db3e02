"""Serving launcher for the port: build a model, submit synthetic requests to
a :class:`~repro_torch.serve.batcher.BatchServer`, drain, report.
Counterpart of ``repro/launch/serve.py`` (its single-replica modes). Runs on
the card unless ``--device cpu`` is given.

  python -m repro_torch.launch.serve --arch minicpm-2b --layers 4 \\
      --slots 4 --requests 8 --max-len 256 --max-new 16 --gemm-impl cuda

``--layers N`` cuts the depth and keeps the published widths. Weights are
random, from ``--seed``. ``--arch falcon-mamba-7b`` serves the Mamba1 stack
(prefill through the selective-scan kernel); its prompts take the per-slot
scatter prefill, as ``--no-prefill-buckets`` makes every model do.
``--arch deepseek-v2-lite-16b`` serves MLA + MoE: prefill through the flash
kernel at d 192 against dv 128, decode through the absorbed latent
attention, the routers through the GEMM provider and the experts' einsums
over the capacity buffer; one card holds the expert banks whole (the
reference's expert/ffn partitions need a mesh: ROADMAP item 15).
``--arch gemma3-4b`` (5 local : 1 global layers, windows of 1024, a
per-layer rope theta; K4 and K5 at head_dim 256), ``mixtral-8x22b`` (GQA +
MoE without shared experts, a window of 4096 on every layer),
``starcoder2-3b`` (layernorm, gelu, a qkv bias) and ``deepseek-coder-33b``
serve through the same path; mixtral and deepseek-coder fit one card only
with ``--layers`` cut (``chip_smoke.py`` serves them at 12 and 19).
``--arch whisper-small`` and ``pixtral-12b`` pass no frontend input, as the
reference's launcher passes none: whisper decodes over a fresh cache's
zeroed cross K/V (its cache has no sequence axis there, so every prompt
takes the scatter prefill, and it cannot be paged), pixtral serves text
only. ``Model.prefill(frames=, patches=)`` is the frontend entry point.

``--paged`` serves from the block-paged cache (page pool and page tables,
prefix sharing, chunked prefill); ``--paged-attention flash`` attends through
the paged kernel. ``--shared-prefix`` gives half the requests a common
16-token prefix and makes the last an exact duplicate of the first, so page
sharing has something to share; ``--compare-contiguous`` serves the same
workload again from the contiguous cache and requires identical tokens. The
run exits non-zero if a request is dropped or misses its token budget, or
(paged) if the page ledger does not balance.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels import compat
from repro_torch.models.model import Model
from repro_torch.serve.batcher import BatchServer, Request


def make_prompts(vocab: int, n_requests: int, rng: np.random.Generator,
                 lo: int = 3, hi: int = 12, shared_prefix: int = 0):
    """``n_requests`` prompts of ``lo``..``hi - 1`` uniform token ids. With
    ``shared_prefix`` > 0 (the reference's shared-prefix workload), the
    even-numbered prompts carry a common ``shared_prefix``-token prefix
    before their own tokens, and with three or more requests the last is an
    exact duplicate of the first (a whole-prompt hit, partial tail page
    included)."""
    lens = rng.integers(lo, hi, n_requests)
    if not shared_prefix:
        return [rng.integers(0, vocab, size=(int(n),)) for n in lens]
    base = rng.integers(0, vocab, size=(shared_prefix,))
    prompts = []
    for i in range(n_requests):
        own = rng.integers(0, vocab, size=(int(lens[i]),))
        prompts.append(np.concatenate([base, own]) if i % 2 == 0 else own)
    if n_requests >= 3:
        prompts[-1] = prompts[0].copy()
    return prompts


def serve(model: Model, params, prompts, *, max_new: int, **server_kw):
    """Submit every prompt with ``max_new`` tokens, drain, and return
    ``(server, completed requests, wall seconds)``. The wall time ends in a
    device sync: the last dispatch's ids were copied to the host."""
    srv = BatchServer(model, device=model.device, **server_kw)
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        srv.submit(Request(rid=i, prompt=p, max_new_tokens=max_new))
    done = srv.run_until_drained(params)
    return srv, done, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced smoke config (small widths)")
    ap.add_argument("--layers", type=int, default=0, metavar="N",
                    help="cut the depth to N layers at full width")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", default="3,12", metavar="LO,HI",
                    help="prompt lengths drawn uniformly from [LO, HI)")
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--decode-chunk", type=int, default=1)
    ap.add_argument("--no-prefill-buckets", action="store_true",
                    help="prefill one prompt at a time into its slot "
                         "(SSM models always do)")
    ap.add_argument("--quantized", action="store_true",
                    help="int8 (F)FIP serving path")
    ap.add_argument("--gemm-algo", choices=["baseline", "fip", "ffip"],
                    default="ffip")
    ap.add_argument("--gemm-impl", choices=["torch", "cuda"], default=None,
                    help="cuda: the hand-written kernels; torch: plain "
                         "PyTorch (default: torch.matmul)")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV cache (page pool + page tables, "
                         "prefix sharing, chunked prefill)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pool size; default slots * max_len / page_size")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="page-aligned prefill chunk width; default max_len "
                         "(one chunk per prompt)")
    ap.add_argument("--paged-attention", choices=["gather", "flash"],
                    default="gather",
                    help="gather: plain attention over a gathered view (the "
                         "contiguous math); flash: the paged kernel")
    ap.add_argument("--shared-prefix", action="store_true",
                    help="half the requests share a 16-token prefix, and "
                         "the last repeats the first prompt")
    ap.add_argument("--compare-contiguous", action="store_true",
                    help="serve the workload again from the contiguous "
                         "cache and require identical tokens (needs "
                         "--paged)")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda:0); 'cpu' for the plain "
                         "versions on the host")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.compare_contiguous and not args.paged:
        ap.error("--compare-contiguous requires --paged")

    cfg = configs.get_config(args.arch)
    if args.smoke:
        cfg = configs.smoke_config(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = Model(cfg, device=args.device)
    params = model.init(args.seed)
    lo, hi = (int(x) for x in args.prompt_len.split(","))
    prompts = make_prompts(cfg.vocab, args.requests,
                           np.random.default_rng(args.seed), lo, hi,
                           shared_prefix=16 if args.shared_prefix else 0)
    server_kw = dict(batch_slots=args.slots, max_len=args.max_len,
                     quantized=args.quantized, gemm_algo=args.gemm_algo,
                     gemm_impl=args.gemm_impl, decode_chunk=args.decode_chunk,
                     prefill_buckets=not args.no_prefill_buckets)
    paged_kw = dict(paged=True, page_size=args.page_size,
                    num_pages=args.num_pages,
                    prefill_chunk=args.prefill_chunk,
                    paged_attention=args.paged_attention) if args.paged else {}

    compat.reset_counters()
    srv, done, dt = serve(model, params, prompts, max_new=args.max_new,
                          **server_kw, **paged_kw)
    total = sum(len(r.out_tokens) for r in done)
    st = srv.stats
    algo = (args.gemm_algo if args.quantized or args.gemm_impl == "cuda"
            else "baseline")
    mode = f"{'int8-' if args.quantized else ''}{algo}/" \
        f"{args.gemm_impl or 'torch'}"
    if args.paged:
        mode += f"/paged-{args.paged_attention}"
    print(f"[{mode}] {cfg.name} L={cfg.n_layers} d={cfg.d_model} on "
          f"{model.device}: {len(done)}/{args.requests} requests / {total} "
          f"tokens in {dt:.3f}s ({total / dt:.1f} tok/s)")
    print(f"  prefill {st['prefill_s']:.3f}s ({st['prefill_tokens']} tok / "
          f"{st['prefill_dispatches']} dispatches), decode "
          f"{st['decode_s']:.3f}s over {st['steps']} steps / "
          f"{st['decode_dispatches']} dispatches ({st['decode_tokens']} tok)")
    if args.paged:
        print(f"  paged: pages_peak={st['pages_peak']}/{srv.num_pages} "
              f"(contiguous equivalent {srv.b * srv.max_pages}), "
              f"prefix_hit_tokens={st['prefix_hit_tokens']}, "
              f"cow_copies={st['cow_copies']}, "
              f"prefill_chunks={st['prefill_chunks']}, page-table upload "
              f"{st['host_bytes_page_tables']} B")
    print(f"  kernel launches: {compat.launch_counts()}")
    if model.device.type == "cuda":
        print(f"  peak device memory "
              f"{torch.cuda.max_memory_allocated(model.device) / 2**30:.2f}"
              f" GiB on {torch.cuda.get_device_name(model.device)}")
    bad = [r.rid for r in done if len(r.out_tokens) != args.max_new]
    if len(done) != args.requests or bad:
        raise SystemExit(f"FAIL: {len(done)} done, short requests {bad}")
    if args.paged:
        if srv._reserved != 0:
            raise SystemExit("FAIL: the page reservation ledger did not drain")
        if srv.alloc.free_count + srv.alloc.in_use != srv.alloc.num_pages:
            raise SystemExit("FAIL: the page allocator leaked")
        if args.shared_prefix and (
                st["prefix_hit_tokens"] <= 0
                or st["pages_peak"] >= srv.b * srv.max_pages):
            raise SystemExit("FAIL: no prefix reuse, or a paged footprint "
                             "no smaller than slots x max_len")
    if args.compare_contiguous:
        _, ref_done, _ = serve(model, params, prompts, max_new=args.max_new,
                               **server_kw)
        got = {r.rid: r.out_tokens for r in done}
        want = {r.rid: r.out_tokens for r in ref_done}
        if got != want:
            raise SystemExit("FAIL: paged tokens differ from the contiguous "
                             "cache's")
        print(f"  compare-contiguous: {total} tokens identical")
    print("OK")


if __name__ == "__main__":
    main()
