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
over the capacity buffer; one card holds the expert banks whole, and
``--mesh-model`` splits them by experts (``BatchServer``'s
``moe_partition``, "expert" or "ffn").
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

``--replicas N`` serves the workload through the fault-tolerant router
(:mod:`repro_torch.serve.router`) over N ``BatchServer`` replicas sharing
the one model's weights (``--quantized-replicas M`` makes the last M int8
FFIP shed targets), with load-aware dispatch, a bounded queue, deadlines
(``--deadline-ms``), bounded retries and a circuit breaker per replica.
``--fault-plan`` installs a deterministic chaos schedule (inline JSON,
``@path``, or ``flaky``: replica 0 flaps raise/hang), driven on a fake
clock; every request must end DONE with its tier's no-fault tokens or
failed with a typed error, and a replica step may raise only what the
plan injects. ``--slo "ttft_ms p99 < 2000"`` (repeatable,
``--slo-windows``, ``--slo-min-count``) turns on the burn-rate degradation
controller, and ``--slo-drain-ticks`` idles the router afterwards so the
alerts clear. ``--metrics-json PATH`` dumps the ``repro_torch.obs``
registry snapshot, ``--trace-out PATH`` the span trace (``.jsonl`` one span
a line, else Chrome ``trace_event`` JSON), ``--metrics-port N`` serves
Prometheus text on 127.0.0.1:N while the run lasts; either of these two
turns the kernel hooks (``repro_torch.obs.profile``) on for the run.

``--gemm-block auto`` picks the kernels' tiles (and looks up K4's) from
the ``repro_torch.tune`` schedule cache, filled by ``python -m
repro_torch.launch.tune``; ``--gemm-block bm,bn,bk`` pins them (with
``--gemm-impl cuda``). ``--prepared DIR`` serves a ``repro_torch.prepare``
artifact (``python -m repro_torch.launch.prepare``) through every server,
the router's replicas included: no quantization, y derivation or carry
table at the first prefill. ``--require-warm`` fails the run, listing the
keys, if a schedule lookup missed or the artifact recomputed offline
work.
``--mesh-model N`` serves tensor-parallel on a (1, N) mesh, one process a
rank (:func:`spawn_ranks`, :func:`rank_main`): nccl with rank r on
``cuda:r`` when the machine has N cards, else gloo with every rank on
``cuda:0`` (ranks sharing one card: the sharded computation and its
collectives, not less memory a rank), and gloo on the CPU with ``--device
cpu``. The launcher prints which. ``falcon-mamba-7b`` and ``zamba2-1.2b``
serve on a mesh too: each rank holds its piece of every Mamba mixer's
d_inner (or heads) and of its streaming state, and runs K6 on its own
channels; ``whisper-small`` holds its heads of the encoder, of the cross
attention and of the cached cross K/V. ``--compare-single-device`` serves
the workload again on one device and requires identical tokens. A rank
that fails, or a run past 900 s, kills the other ranks and fails the run.
``--replicas`` with ``--mesh-model``: every rank runs the router over its
replicas, each a ``BatchServer(mesh=)``, on a fake clock (every decision
must be the same on every rank), each tier's replicas sharing one
preparation and one cut of the weights; the run fails if the ranks' router
events, outcomes or tokens differ. ``--mesh-model`` with ``--paged`` is
refused, as the reference refuses a paged cache on a mesh.

``python -m repro_torch.launch.obs_check`` checks the two files:

  python -m repro_torch.launch.serve --arch minicpm-2b --smoke --device cpu \
      --slots 2 --requests 8 --max-new 4 --replicas 2 --quantized-replicas 1 \
      --fault-plan flaky --slo "ttft_ms p99 < 2000" --slo-windows 2,8 \
      --slo-min-count 2 --slo-drain-ticks 1600 --metrics-json m.json \
      --trace-out t.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import multiprocessing
import pathlib
import pickle
import sys
import tempfile
import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.obs as obs
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


# ---------------------------------------------------------------------------
# Tensor-parallel ranks: one process a rank
# ---------------------------------------------------------------------------

class RankError(RuntimeError):
    """A rank of a tensor-parallel run failed or outlived its time limit;
    the other ranks were killed."""


def mesh_backend(tp: int, device: str) -> Tuple[str, List[str]]:
    """(backend, each rank's device) for ``tp`` ranks: nccl with rank r on
    ``cuda:r`` when there are ``tp`` cards; gloo with every rank on
    ``cuda:0`` on fewer (NCCL refuses two ranks on one device); gloo on the
    CPU for ``cpu``."""
    if device == "cpu":
        return "gloo", ["cpu"] * tp
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: tensor-parallel ranks run on the "
                           "card unless the caller passes device='cpu'")
    if torch.cuda.device_count() >= tp:
        return "nccl", [f"cuda:{r}" for r in range(tp)]
    return "gloo", ["cuda:0"] * tp


def mesh_shape(shape) -> Tuple[int, int]:
    """The ("data", "model") shape of ``spawn_ranks``' ``shape``: an int
    ``tp`` is (1, tp), tensor parallelism alone."""
    if isinstance(shape, int):
        return (1, shape)
    data, model = (int(n) for n in shape)
    return (data, model)


def rank_main(rank: int, shape, store: str, backend: str, device: str,
              jobs: Sequence[Tuple[Callable, dict]], out: str,
              timeout_s: float) -> None:
    """One rank: join the process group through the ``file://`` store, build
    the ("data", "model") mesh of ``shape`` (an int: (1, shape)), run each
    job ``fn(mesh, device, **kwargs)`` in order and pickle the list of
    their results to ``out``. On the CPU a rank keeps to one intra-op
    thread (the ranks share the host's cores). A rank only loads the
    kernels its parent built: it never builds into the shared kernel
    directory."""
    from repro_torch.dist import context as dctx

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        missing = compat.missing_builds()
        if missing:
            raise RuntimeError(f"rank {rank}: kernels not built by the "
                               f"parent: {missing}")
    else:
        torch.set_num_threads(1)
    shape = mesh_shape(shape)
    dist.init_process_group(backend, init_method=store,
                            world_size=shape[0] * shape[1], rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh = dctx.make_mesh(shape, ("data", "model"))
        results = [fn(mesh, dev, **kw) for fn, kw in jobs]
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(results, f)


def spawn_ranks(shape, jobs: Sequence[Tuple[Callable, dict]], *,
                device: str = "cuda", timeout_s: float = 900.0) -> list:
    """Run ``jobs`` on the ranks of a ("data", "model") mesh of ``shape``
    (an int ``tp``: (1, tp), as the serving callers run) and return each
    rank's list of results (rank order). The ranks start by ``spawn`` (the
    parent may hold CUDA);
    the jobs and their kwargs must pickle, functions by import path. On the
    card every kernel is built here first, so that no two ranks build. The
    parent polls: a rank that exits non-zero, or a run past ``timeout_s``,
    kills the others and raises :class:`RankError`, so a rank that dies
    mid-collective never leaves the others waiting."""
    shape = mesh_shape(shape)
    tp = shape[0] * shape[1]
    backend, devices = mesh_backend(tp, device)
    if devices[0] != "cpu":
        compat.build_all()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as d:
        store = f"file://{pathlib.Path(d) / 'store'}"
        outs = [str(pathlib.Path(d) / f"rank{r}.pkl") for r in range(tp)]
        procs = [ctx.Process(target=rank_main, name=f"rank{r}",
                             args=(r, shape, store, backend, devices[r],
                                   jobs, outs[r], timeout_s))
                 for r in range(tp)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                bad = [p for p in procs
                       if p.exitcode is not None and p.exitcode != 0]
                if bad:
                    failed = (f"{bad[0].name} exited with code "
                              f"{bad[0].exitcode}")
                    break
                if time.monotonic() > deadline:
                    failed = f"the ranks ran past {timeout_s:.0f} s"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=30)
        if failed is None:
            bad = [p for p in procs if p.exitcode != 0]
            if bad:
                failed = f"{bad[0].name} exited with code {bad[0].exitcode}"
        if failed is not None:
            raise RankError(f"mesh run ({backend}, {shape[0]} x {shape[1]} "
                            f"ranks) failed: {failed}; the other ranks were "
                            f"killed")
        results = []
        for out in outs:
            with open(out, "rb") as f:
                results.append(pickle.load(f))
    return results


def build_config(arch: str, smoke: bool = False, layers: int = 0):
    """``arch``'s config, its smoke widths with ``smoke``, cut to ``layers``
    layers when given."""
    cfg = configs.get_config(arch)
    if smoke:
        cfg = configs.smoke_config(cfg)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def serve_job(mesh, device, *, arch: str, smoke: bool = False,
              layers: int = 0, seed: int = 0, prompts, max_new: int,
              server_kw: dict, prepared: str = "", plant=None,
              metrics_json: str = "", trace_out: str = "") -> dict:
    """A rank's part of a tensor-parallel serving run: the model from
    ``seed`` (every rank draws the same whole weights, and the server cuts
    its pieces), ``plant(params, mesh)`` applied when given, the prompts
    served through ``BatchServer(mesh=)``. Returns the tokens, stats,
    launch counts, peak device memory and, with ``prepared`` (an artifact
    directory, loaded on this rank), its recompute report. Rank 0 alone
    writes ``metrics_json`` and ``trace_out``."""
    from repro_torch import tune

    cfg = build_config(arch, smoke, layers)
    model = Model(cfg, device=device)
    params = model.init(seed)
    if plant is not None:
        params = plant(params, mesh)
    pm = None
    if prepared:
        from repro_torch import prepare
        pm = prepare.load(prepared, map_location=device)
    tune.reset_stats()
    compat.reset_counters()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    srv, done, wall = serve(model, params, prompts, max_new=max_new,
                            mesh=mesh, prepared=pm, **server_kw)
    if mesh.index("model") == 0 and (metrics_json or trace_out):
        write_obs(argparse.Namespace(metrics_json=metrics_json,
                                     trace_out=trace_out), srv.tracer)
    return dict(
        tokens={r.rid: list(r.out_tokens) for r in done},
        stats=dict(srv.stats), wall_s=wall,
        launches=compat.launch_counts(),
        peak_gib=(torch.cuda.max_memory_allocated(device) / 2 ** 30
                  if device.type == "cuda" else 0.0),
        recomputed=None if pm is None else pm.recompute_report(),
        built=None if srv._local_prepared is None
        else srv._local_prepared.built,
        tune_misses=int(tune.stats["misses"]),
        tune_missed=sorted(tune._warned_keys))


def router_job(mesh, device, *, arch: str, smoke: bool = False,
               layers: int = 0, seed: int = 0, prompts, router_args: dict,
               server_kw: dict, prepared: str = "", metrics_json: str = "",
               trace_out: str = "") -> dict:
    """A rank's part of ``--replicas`` with ``--mesh-model``: the model from
    ``seed`` (the same whole weights on every rank), the prompts served
    through :func:`serve_router` on this rank's mesh (``router_args``: the
    launcher's arguments it reads: ``replicas``, ``quantized_replicas``,
    ``quantized``, ``fault_plan``, ``deadline_ms``, ``slo``,
    ``slo_windows``, ``slo_min_count``, ``slo_drain_ticks``, ``max_new``,
    ``paged``). Returns the router's gate failures,
    events, outcomes, stats and each DONE request's tokens (every rank's
    must be equal), the launch counts, the peak device memory and what the
    router printed. ``prepared``: an artifact directory, loaded on this
    rank and served by every replica. Rank 0 alone writes ``metrics_json``
    and ``trace_out``."""
    import contextlib
    import io

    from repro_torch.serve.lifecycle import Lifecycle

    cfg = build_config(arch, smoke, layers)
    model = Model(cfg, device=device)
    params = model.init(seed)
    if prepared:
        from repro_torch import prepare
        server_kw = dict(server_kw, prepared=prepare.load(
            prepared, map_location=device))
    compat.reset_counters()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        problems, rt = serve_router(model, params, prompts,
                                    argparse.Namespace(**router_args),
                                    server_kw, mesh=mesh)
    if mesh.index("model") == 0 and (metrics_json or trace_out):
        write_obs(argparse.Namespace(metrics_json=metrics_json,
                                     trace_out=trace_out), rt.tracer)
    return dict(
        problems=problems, events=list(rt.events),
        outcomes=rt.outcome_counts(), stats=dict(rt.stats),
        tokens={rid: list(rec.tokens) for rid, rec in rt.records.items()
                if rec.state is Lifecycle.DONE},
        launches=compat.launch_counts(),
        peak_gib=(torch.cuda.max_memory_allocated(device) / 2 ** 30
                  if device.type == "cuda" else 0.0),
        printed=printed.getvalue())


def unplanned_failures(events) -> list:
    """The replica failures in a router's ``events`` that no fault plan
    made: a step may raise only the plan's ``InjectedFault``, or a
    ``RuntimeError`` while an ``exhaust`` fault holds its replica's page pool
    (between that replica's ``exhaust_begin`` and ``exhaust_end``); a hang is
    a ``replica_hang``, never a failure. Anything else (an out-of-memory
    error, a kernel's) is a fault of the program that the router would
    otherwise absorb as a failover."""
    drained, bad = set(), []
    for ev in events:
        if ev[0] == "exhaust_begin":
            drained.add(ev[1])
        elif ev[0] == "exhaust_end":
            drained.discard(ev[1])
        elif ev[0] == "replica_failure":
            _, idx, tick, name = ev
            if not (name == "InjectedFault"
                    or (name == "RuntimeError" and idx in drained)):
                bad.append(f"replica {idx} step raised {name} at tick "
                           f"{tick}, which no fault plan injected")
    return bad


def serve_router(model: Model, params, prompts, args, server_kw: dict,
                 mesh=None):
    """The multi-replica path (``--replicas``), as the reference's: returns
    ``(problems, router)``. Under a fault plan every replica reads the
    router's fake clock, so latencies and spans follow the fault schedule,
    and a kernel's first launch costs no fake time.

    ``mesh``: this process is one rank of a tensor-parallel run and every
    replica a ``BatchServer(mesh=)``. Each rank runs its own router over its
    pieces, and every decision must be the same on every rank, or one rank
    waits in a collective that another never joins: the router and the
    replicas then run on a FakeClock whether or not a fault plan is given
    (deadlines, step timeouts, quarantines and SLO windows all read it, and
    it moves only with the router's ticks and the plan's hangs, never with
    a rank's wall clock). Each tier's replicas share one preparation
    (``repro_torch.prepare``, unless ``server_kw`` brings one), and through
    it one cut of the weights."""
    from repro_torch.serve.faults import FakeClock, FaultPlan
    from repro_torch.serve.lifecycle import Lifecycle, ServeStallError
    from repro_torch.serve.router import ReplicaRouter, RouterConfig

    plan = None
    if args.fault_plan:
        plan = (FaultPlan.flaky_replica(0) if args.fault_plan == "flaky"
                else FaultPlan.parse(args.fault_plan))
    nq = min(args.quantized_replicas, args.replicas)
    tiers = [i >= args.replicas - nq for i in range(args.replicas)]
    clock = FakeClock() if plan is not None or mesh is not None else None
    shared = {}
    if mesh is not None and server_kw.get("prepared") is None:
        from repro_torch import prepare
        shared = {q: prepare.prepare_lm(params, quantized=q)
                  for q in sorted({q or args.quantized for q in tiers})}
    objectives = None
    if args.slo:
        fast_s, slow_s = (float(x) for x in args.slo_windows.split(","))
        objectives = [obs.Objective.parse(
            spec, fast_window_s=fast_s, slow_window_s=slow_s,
            min_count=args.slo_min_count) for spec in args.slo]

    def mk(q):
        kw = dict(server_kw, quantized=q)
        if q in shared:
            kw["prepared"] = shared[q]
        return BatchServer(model, device=model.device, mesh=mesh, clock=clock,
                           **kw)

    servers = [mk(q or args.quantized) for q in tiers]
    rt = ReplicaRouter(servers, params, fault_plan=plan, clock=clock,
                       cfg=RouterConfig(
                           step_timeout_s=5.0, quarantine_s=0.2,
                           max_retries=4, objectives=objectives,
                           default_deadline_s=(args.deadline_ms / 1000.0
                                               if args.deadline_ms else
                                               None)))
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        rt.submit(Request(rid=i, prompt=p, max_new_tokens=args.max_new,
                          eos_id=-1))
    try:
        recs = rt.drive(max_ticks=50_000)
    except ServeStallError as e:
        raise SystemExit(f"FAIL: {e}")
    # idle ticks so the burn windows expire and the degradation controller
    # walks back to healthy (obs_check's recovery gate)
    for _ in range(args.slo_drain_ticks):
        rt.step()
    dt = time.perf_counter() - t0

    # the no-fault single-server oracle of each tier that served work
    want = {}
    for q in sorted({rec.tier == "int8" for rec in recs.values()
                     if rec.state is Lifecycle.DONE}):
        ref = mk(q)
        for i, p in enumerate(prompts):
            ref.submit(Request(rid=i, prompt=p, max_new_tokens=args.max_new,
                               eos_id=-1))
        want[q] = {r.rid: list(r.out_tokens)
                   for r in ref.run_until_drained(params)}

    outcomes = rt.outcome_counts()
    done = [rec for rec in recs.values() if rec.state is Lifecycle.DONE]
    lat = np.array(sorted(rec.t_done - rec.t_submit for rec in done)) \
        if done else np.zeros((0,))
    unit = "fake-s" if clock is not None else "s"
    mode = (f"router x{args.replicas}"
            + (f" ({nq} int8 shed targets)" if nq else "")
            + ("/paged" if args.paged else "")
            + (f"/faults[{len(plan.faults)}]" if plan is not None else ""))
    print(f"[{mode}] {len(done)}/{len(prompts)} done in {dt:.2f}s wall, "
          f"outcomes {outcomes}")
    if len(lat):
        print(f"  e2e latency ({unit}): p50={np.percentile(lat, 50):.4f} "
              f"p99={np.percentile(lat, 99):.4f}")
    print(f"  router: {rt.stats}")
    if rt.slo is not None:
        states = {k: v.name for k, v in rt.slo.states().items()}
        ctl = {key[0]: int(c.value) for key, c in
               rt.registry.get("router_controller_total")._children.items()}
        print(f"  slo: states={states} controller={rt.ctl_state} "
              f"actions={ctl}")

    problems = []
    if any(not rec.terminal for rec in recs.values()):
        problems.append("non-terminal requests after drive()")
    for rec in recs.values():
        if rec.state is Lifecycle.DONE:
            if rec.tokens != want[rec.tier == "int8"][rec.req.rid]:
                problems.append(
                    f"rid {rec.req.rid}: tokens diverge from the no-fault "
                    f"{rec.tier} oracle")
        elif rec.error is None:
            problems.append(f"rid {rec.req.rid}: failed without a typed "
                            f"error ({rec.state.value})")
    if plan is None and args.deadline_ms is None and len(done) != len(recs):
        problems.append("requests failed with no faults injected")
    problems += unplanned_failures(rt.events)
    for s in servers:
        if s.paged and s._reserved != 0:
            problems.append("page reservation ledger did not drain to 0")
    return problems, rt


def write_obs(args, tracer) -> None:
    """Dump --metrics-json / --trace-out (before the gates fail a run, so a
    failing run leaves its telemetry behind)."""
    if args.metrics_json:
        payload = {"metrics": obs.get_registry().snapshot(),
                   "compile": obs.compile_snapshot()}
        with open(args.metrics_json, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        print(f"  obs: metrics -> {args.metrics_json}")
    if args.trace_out and tracer is not None:
        tracer.write(args.trace_out)
        print(f"  obs: trace ({len(tracer.spans)} spans, "
              f"{tracer.dropped} dropped) -> {args.trace_out}")


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
    ap.add_argument("--gemm-block", default=None, metavar="auto|BM,BN,BK",
                    help="'auto' (the repro_torch.tune schedule cache; also "
                         "looks up the flash tile) or explicit 'bm,bn,bk' "
                         "(needs --gemm-impl cuda)")
    ap.add_argument("--prepared", default=None, metavar="DIR",
                    help="serve from a repro_torch.prepare artifact "
                         "(python -m repro_torch.launch.prepare)")
    ap.add_argument("--require-warm", action="store_true",
                    help="fail, listing the missing keys, if any schedule "
                         "lookup missed or the prepared artifact recomputed "
                         "offline work")
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
    ap.add_argument("--replicas", type=int, default=0, metavar="N",
                    help="serve through the multi-replica router over N "
                         "BatchServer replicas (0 = one server, the "
                         "default)")
    ap.add_argument("--quantized-replicas", type=int, default=0, metavar="M",
                    help="make the last M of --replicas int8-FFIP shed "
                         "targets (graceful degradation under pressure)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request end-to-end deadline for the router "
                         "path (typed TIMED_OUT past it)")
    ap.add_argument("--fault-plan", default=None, metavar="JSON|@FILE|flaky",
                    help="deterministic chaos schedule for the router path "
                         "(inline JSON, @path, or 'flaky'); runs on a fake "
                         "clock")
    ap.add_argument("--slo", action="append", default=None, metavar="SPEC",
                    help="SLO objective for the router path, repeatable: "
                         "'ttft_ms p99 < 2000' or 'error_rate < 0.25'; "
                         "turns on the burn-rate degradation controller")
    ap.add_argument("--slo-windows", default="5,30", metavar="FAST,SLOW",
                    help="burn-rate window lengths in (fake) seconds")
    ap.add_argument("--slo-min-count", type=int, default=3,
                    help="min samples per window before an SLO can PAGE")
    ap.add_argument("--slo-drain-ticks", type=int, default=0, metavar="N",
                    help="idle router ticks after the workload drains, so "
                         "burn windows expire and the controller recovers")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the repro_torch.obs registry snapshot (+ "
                         "the compile counters) as JSON at exit")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the span trace: *.jsonl one span a line, "
                         "else Chrome trace_event JSON (Perfetto)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="N",
                    help="serve Prometheus text on 127.0.0.1:N/metrics "
                         "while the run lasts (0 = a free port)")
    ap.add_argument("--mesh-model", type=int, default=0, metavar="N",
                    help="tensor-parallel serving on a (1, N) mesh, one "
                         "process a rank (repro_torch.dist)")
    ap.add_argument("--compare-single-device", action="store_true",
                    help="serve the workload again on one device and "
                         "require identical tokens (needs --mesh-model)")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda:0); 'cpu' for the plain "
                         "versions on the host")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.compare_contiguous and not args.paged:
        ap.error("--compare-contiguous requires --paged")
    if args.compare_single_device and not args.mesh_model:
        ap.error("--compare-single-device requires --mesh-model")
    if args.mesh_model and args.paged:
        raise SystemExit("--mesh-model with --paged is refused, as the "
                         "reference refuses a paged cache on a mesh (the "
                         "page pool is host-managed per device)")
    if args.compare_single_device and args.replicas:
        ap.error("--compare-single-device does not take --replicas (the "
                 "router's no-fault oracles hold its tokens)")
    if args.slo and not args.replicas:
        ap.error("--slo requires --replicas (the burn-rate degradation "
                 "controller lives in the router)")
    args.gemm_block_parsed = args.gemm_block
    if args.gemm_block and args.gemm_block != "auto":
        args.gemm_block_parsed = tuple(
            int(x) for x in args.gemm_block.split(","))
        if len(args.gemm_block_parsed) != 3:
            ap.error("--gemm-block takes 'auto' or bm,bn,bk")
    # a fresh registry and profiler a run, so --metrics-json holds exactly
    # this run (servers, routers and kernel hooks resolve the default at
    # construction); the kernel hooks count only when the run's metrics are
    # read. All three are put back at the end: the run's registry holds its
    # router (an SLO window's clock), and through it every replica.
    prev = (obs.set_registry(obs.Registry()), obs.profile.set_profiler(None),
            obs.profile.enable(bool(args.metrics_json)
                               or args.metrics_port is not None))
    httpd = None
    try:
        if args.metrics_port is not None:
            httpd = obs.start_metrics_server(obs.get_registry(),
                                             port=args.metrics_port)
            print(f"metrics: http://{httpd.server_address[0]}:"
                  f"{httpd.server_address[1]}/metrics")
        _run_mesh(args) if args.mesh_model else _run(args)
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        obs.set_registry(prev[0])
        obs.profile.set_profiler(prev[1])
        obs.profile.enable(prev[2])


def _run(args) -> None:
    cfg = build_config(args.arch, args.smoke, args.layers)
    model = Model(cfg, device=args.device)
    params = model.init(args.seed)
    lo, hi = (int(x) for x in args.prompt_len.split(","))
    prompts = make_prompts(cfg.vocab, args.requests,
                           np.random.default_rng(args.seed), lo, hi,
                           shared_prefix=16 if args.shared_prefix else 0)
    prepared = _load_prepared(args, model.device)
    if args.require_warm:
        from repro_torch import tune
        tune.reset_stats()
    server_kw = dict(batch_slots=args.slots, max_len=args.max_len,
                     quantized=args.quantized, gemm_algo=args.gemm_algo,
                     gemm_impl=args.gemm_impl,
                     gemm_block=args.gemm_block_parsed,
                     decode_chunk=args.decode_chunk,
                     prefill_buckets=not args.no_prefill_buckets,
                     prepared=prepared)
    paged_kw = dict(paged=True, page_size=args.page_size,
                    num_pages=args.num_pages,
                    prefill_chunk=args.prefill_chunk,
                    paged_attention=args.paged_attention) if args.paged else {}

    compat.reset_counters()
    if args.replicas:
        problems, rt = serve_router(model, params, prompts, args,
                                    dict(server_kw, **paged_kw))
        print(f"  kernel launches: {compat.launch_counts()}")
        write_obs(args, rt.tracer)
        problems += _warm_problems(args, prepared)
        if problems:
            print("FAIL:\n  " + "\n  ".join(problems), file=sys.stderr)
            raise SystemExit(1)
        print("OK")
        return
    srv, done, dt = serve(model, params, prompts, max_new=args.max_new,
                          **server_kw, **paged_kw)
    write_obs(args, srv.tracer)
    total = sum(len(r.out_tokens) for r in done)
    st = srv.stats
    algo = (args.gemm_algo if args.quantized or args.gemm_impl == "cuda"
            else "baseline")
    mode = f"{'int8-' if args.quantized else ''}{algo}/" \
        f"{args.gemm_impl or 'torch'}"
    if args.paged:
        mode += f"/paged-{args.paged_attention}"
    if prepared is not None:
        mode += "/prepared"
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
    if args.gemm_block == "auto":
        from repro_torch import tune
        print(f"  tune: {tune.stats['hits']} schedule hits / "
              f"{tune.stats['misses']} misses (cache: "
              f"{tune.get_cache().path})")
    problems = _warm_problems(args, prepared)
    if problems:
        print("--require-warm: FAIL\n  " + "\n  ".join(problems),
              file=sys.stderr)
        raise SystemExit(1)
    print("OK")


def _run_mesh(args) -> None:
    """``--mesh-model N``: the workload on N ranks (:func:`serve_job`),
    reported here from rank 0's result, each rank's peak memory and launch
    counts beside it; then ``--compare-single-device``."""
    cfg = build_config(args.arch, args.smoke, args.layers)
    device = args.device or "cuda"
    backend, devices = mesh_backend(args.mesh_model, device)
    lo, hi = (int(x) for x in args.prompt_len.split(","))
    prompts = make_prompts(cfg.vocab, args.requests,
                           np.random.default_rng(args.seed), lo, hi,
                           shared_prefix=16 if args.shared_prefix else 0)
    server_kw = dict(batch_slots=args.slots, max_len=args.max_len,
                     quantized=args.quantized, gemm_algo=args.gemm_algo,
                     gemm_impl=args.gemm_impl,
                     gemm_block=args.gemm_block_parsed,
                     decode_chunk=args.decode_chunk,
                     prefill_buckets=not args.no_prefill_buckets)
    job = dict(arch=args.arch, smoke=args.smoke, layers=args.layers,
               seed=args.seed, prompts=prompts,
               server_kw=server_kw, prepared=args.prepared or "",
               metrics_json=args.metrics_json or "",
               trace_out=args.trace_out or "")
    print(f"mesh (1, {args.mesh_model}): {backend} on "
          f"{', '.join(devices)}", flush=True)
    if args.replicas:
        _run_mesh_router(args, job, device)
        return
    job["max_new"] = args.max_new
    t0 = time.perf_counter()
    try:
        ranks = spawn_ranks(args.mesh_model, [(serve_job, job)],
                            device=device)
    except RankError as e:
        raise SystemExit(f"FAIL: {e}")
    wall = time.perf_counter() - t0
    res = [r[0] for r in ranks]
    got = res[0]["tokens"]
    st = res[0]["stats"]
    total = sum(len(t) for t in got.values())
    print(f"[tp{args.mesh_model}] {cfg.name} L={cfg.n_layers} "
          f"d={cfg.d_model}: {len(got)}/{args.requests} requests / {total} "
          f"tokens; {wall:.2f}s with the ranks' start")
    print(f"  prefill {st['prefill_s']:.3f}s ({st['prefill_tokens']} tok / "
          f"{st['prefill_dispatches']} dispatches), decode "
          f"{st['decode_s']:.3f}s over {st['steps']} steps / "
          f"{st['decode_dispatches']} dispatches ({st['decode_tokens']} tok)")
    for r, rec in enumerate(res):
        print(f"  rank {r}: kernel launches {rec['launches']}, peak device "
              f"memory {rec['peak_gib']:.2f} GiB")
    problems = []
    if any(rec["tokens"] != got for rec in res[1:]):
        problems.append("the ranks returned different tokens")
    bad = [rid for rid, t in got.items() if len(t) != args.max_new]
    if len(got) != args.requests or bad:
        problems.append(f"{len(got)} done, short requests {bad}")
    if args.compare_single_device:
        model = Model(cfg, device=devices[0])
        prepared = _load_prepared(args, model.device)
        _, done, _ = serve(model, model.init(args.seed), prompts,
                           max_new=args.max_new, prepared=prepared,
                           **server_kw)
        want = {r.rid: list(r.out_tokens) for r in done}
        if want != got:
            problems.append(f"tp{args.mesh_model} tokens differ from the "
                            f"single device's")
        else:
            print(f"  compare-single-device: {total} tokens identical at "
                  f"tp={args.mesh_model}")
    if args.require_warm:
        for r, rec in enumerate(res):
            if rec["tune_misses"]:
                problems.append(f"rank {r}: {rec['tune_misses']} schedule "
                                f"misses: {rec['tune_missed']}")
            if rec["recomputed"] and any(rec["recomputed"].values()):
                problems.append(f"rank {r}: prepared artifact recomputed "
                                f"offline work: {rec['recomputed']}")
        if not problems:
            print("  require-warm: 0 schedule misses"
                  + (", prepared.recomputed == 0" if args.prepared else ""))
    if problems:
        print("FAIL:\n  " + "\n  ".join(problems), file=sys.stderr)
        raise SystemExit(1)
    print("OK")


def _run_mesh_router(args, job: dict, device: str) -> None:
    """``--replicas`` with ``--mesh-model``: the router on every rank
    (:func:`router_job`), reported from rank 0 (what its router printed,
    each rank's peak memory and launch counts). The run fails on rank 0's
    gate failures (its tier oracles, typed errors, unplanned failures) or
    on any rank whose router events, outcomes or tokens differ from rank
    0's: the ranks must have taken every decision alike."""
    job["router_args"] = vars(args)
    try:
        ranks = spawn_ranks(args.mesh_model, [(router_job, job)],
                            device=device)
    except RankError as e:
        raise SystemExit(f"FAIL: {e}")
    res = [r[0] for r in ranks]
    print(res[0]["printed"], end="")
    for r, rec in enumerate(res):
        print(f"  rank {r}: kernel launches {rec['launches']}, peak device "
              f"memory {rec['peak_gib']:.2f} GiB")
    problems = list(res[0]["problems"])
    for r, rec in enumerate(res[1:], 1):
        problems += [f"rank {r}: {p}" for p in rec["problems"]
                     if p not in res[0]["problems"]]
        problems += [f"rank {r}'s router {key} differ from rank 0's"
                     for key in ("events", "outcomes", "tokens")
                     if rec[key] != res[0][key]]
    if problems:
        print("FAIL:\n  " + "\n  ".join(problems), file=sys.stderr)
        raise SystemExit(1)
    print(f"  ranks agree: {len(res[0]['events'])} router events, outcomes "
          f"{res[0]['outcomes']}, {len(res[0]['tokens'])} requests' tokens "
          f"identical on {args.mesh_model} ranks")
    print("OK")


def _load_prepared(args, device):
    """The ``--prepared`` artifact on ``device``, or None. An unusable one
    (quarantined by the loader) falls back to preparing in the process,
    unless ``--require-warm`` asked for the warm start."""
    if not args.prepared:
        return None
    from repro_torch import prepare
    t0 = time.perf_counter()
    try:
        pm = prepare.load(args.prepared, map_location=device)
    except prepare.ArtifactError as e:
        if args.require_warm:
            raise SystemExit(f"--require-warm but the prepared artifact is "
                             f"unusable: {e}")
        print(f"WARNING: prepared artifact unusable ({e}); falling back to "
              f"in-process preparation", file=sys.stderr)
        return None
    print(f"loaded prepared artifact {args.prepared} ({len(pm.derived)} "
          f"y-deltas, {len(pm.schedule)} schedule entries, built at load "
          f"{pm.built}, {time.perf_counter() - t0:.2f}s)")
    return pm


def _warm_problems(args, prepared) -> list:
    """``--require-warm``'s failures: schedule misses (with their keys) and
    offline work the artifact recomputed; the passed checks are printed."""
    if not args.require_warm:
        return []
    from repro_torch import tune
    problems = []
    if tune.stats["misses"]:
        problems.append(
            f"{tune.stats['misses']} schedule-cache misses fell back to "
            f"defaults:\n    " + "\n    ".join(sorted(tune._warned_keys)))
    if prepared is not None and prepared.recomputed:
        problems.append(f"prepared artifact recomputed offline work: "
                        f"{prepared.recompute_report()}")
    if not problems:
        checks = ["0 schedule misses"]
        if prepared is not None:
            checks.append("prepared.recomputed == 0")
        print(f"  require-warm: {', '.join(checks)}")
    return problems


if __name__ == "__main__":
    main()
