"""The port's ``repro_torch.obs`` against the reference's ``repro.obs``, and
the contracts it carries through the port's serving stack.

Parity (the same sequence of observations, on one FakeClock timeline, fed
to each package's own classes; every output compared exactly):
* metrics: counters, gauges, histograms (an overflowed reservoir too),
  windowed histograms and counters, escaped HELP and label text -> the
  Prometheus text, ``snapshot()``/``to_json()`` and the quantiles;
* trace: a ring that drops spans, nested spans, point events -> the JSONL
  and Chrome exports, ``span_tree`` per rid and ``tree_from_spans`` over
  the reloaded JSONL;
* windows: boundary expiry, a clock jump past the window, multi-window
  queries, labelled-family aggregation;
* SLOs: the scenarios of tests/test_slo.py -> the alert state and burns
  after every evaluation, the metric snapshot and the slo_alert events;
* profile: the same record_* calls -> the same snapshot; the watchdog's
  labelled counters -> the same snapshot.

Port only: the FIP multiplier accounting (Eqs. 1/5/7), the hooks at the
real call sites counting a CPU call as a dispatch once ``enable(True)``
turns them on (off by default), ``enable(False)``,
``compile_snapshot``; the watchdog's ``{loop}`` counters and the train
alias; the batcher's clock injection and per-drain stats; the bounded
``events`` view; a retried request's span tree through the router; the
router's e2e histogram; the label-cardinality guard and the scrape
endpoint.
"""
import dataclasses
import inspect
import json
import types

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.watchdog as jwatchdog
import repro_torch.obs as obs
import repro_torch.watchdog as pwatchdog
from repro.obs import profile as jprofile
from repro.serve.faults import FakeClock as JFakeClock
from repro_torch import configs
from repro_torch.models.model import Model
from repro_torch.obs import (CardinalityError, Registry, parse_prometheus,
                             start_metrics_server)
from repro_torch.obs import profile as obs_profile
from repro_torch.serve.batcher import BatchServer, Request
from repro_torch.serve.faults import FakeClock, FaultPlan, FaultSpec
from repro_torch.serve.lifecycle import Lifecycle
from repro_torch.serve.router import ReplicaRouter, RouterConfig
from repro_torch.train.watchdog import StepWatchdog
from repro_torch.watchdog import HangError, Watchdog, WatchdogConfig

REF = types.SimpleNamespace(obs=jobs, clock=JFakeClock, profile=jprofile,
                            watchdog=jwatchdog)
PORT = types.SimpleNamespace(obs=obs, clock=FakeClock, profile=obs_profile,
                             watchdog=pwatchdog)

MAX_LEN = 48
MAX_NEW = 4
LENS = [3, 7, 5]


# -- parity scenarios: each takes a package namespace, returns outputs -------

def _metrics_mixed(ns, tmp_path=None):
    clock = ns.clock()
    r = ns.obs.Registry()
    c = r.counter("req_total", "requests\nper replica \\ phase",
                  ("replica", "phase"))
    g = r.gauge("depth", 'queue "depth"')
    h = r.histogram("lat_s", "latency", ("phase",), buckets=(0.01, 0.1, 1.0),
                    reservoir=4)
    wh = r.windowed_histogram("ttft_w", "t", ("replica", "tier"),
                              window_s=4.0, sub_buckets=4, clock=clock)
    wc = r.windowed_counter("bad_w", "b", window_s=4.0, sub_buckets=4,
                            clock=clock)
    out = []
    for i in range(12):
        clock.advance(0.25 * (i % 3 + 1))
        c.labels(replica=str(i % 2), phase='pre"fill' if i % 3 else
                 "decode").inc(i)
        g.set(i * 0.5)
        g.dec(0.25)
        h.labels(phase="decode" if i % 2 else "prefill").observe(
            0.003 * i * i)
        wh.labels(replica=str(i % 2), tier="int8" if i % 4 else
                  "float").observe(0.01 * i)
        wc.inc(i % 3)
        out.append((wh.quantile(0.5), wh.quantile(0.99, 1.0), wh.count(),
                    wc.count(), wc.rate(2.0)))
    for q in (0.0, 0.5, 0.9, 1.0):
        out.append(h.labels(phase="decode").quantile(q))
    return r.to_prometheus(), r.to_json(), out


def _trace(ns, tmp_path):
    clock = ns.clock()
    t = ns.obs.Tracer(clock=clock, capacity=10)
    for rid in range(4):
        root = t.start("request", rid=str(rid), prompt=rid + 3)
        q = t.start("queued", parent=root.sid, rid=str(rid), attempt=0)
        clock.advance(0.01 * (rid + 1))
        t.end(q)
        t.event("retry", parent=root.sid, rid=str(rid), error="X")
        with t.span("decoding", parent=root.sid, rid=str(rid)) as s:
            s.set(chunk=2)
            clock.advance(0.02)
        t.end(root, outcome="done")
    t.event("controller", action="tighten")
    path = tmp_path / f"{ns.obs.__name__}.jsonl"
    t.write(str(path))
    trees = [t.span_tree(str(rid)) for rid in range(4)]
    loaded = [ns.obs.tree_from_spans(ns.obs.load_jsonl(str(path)), str(rid))
              for rid in range(4)]
    return (t.to_jsonl(), json.dumps(t.to_chrome_trace(), sort_keys=True),
            t.dropped, trees, loaded, t.rids())


def _windows(ns, tmp_path=None):
    clock = ns.clock()
    r = ns.obs.Registry()
    h = r.windowed_histogram("w_s", "t", ("k",), window_s=4.0,
                             sub_buckets=4, clock=clock,
                             reservoir_per_bucket=3)
    out = []
    clock.t = 1.0
    h.labels(k="a").observe(5.0)
    out.append((h.count(now=1.0), h.count(now=4.999), h.count(now=5.0)))
    for i in range(10):
        clock.advance(0.5)
        h.labels(k="ab"[i % 2]).observe(float(i))
        out.append((h.quantile(0.5), h.quantile(0.9, 2.0), h.count(2.0),
                    h.labels(k="a").count(), h.rate()))
    clock.advance(100.0)
    out.append((h.count(), h.quantile(0.5)))
    return r.to_prometheus(), r.to_json(), out


def _slo_page(ns, tmp_path=None):
    clock = ns.clock()
    reg = ns.obs.Registry()
    tr = ns.obs.Tracer(clock=clock)
    mon = ns.obs.SloMonitor(
        [ns.obs.Objective("lat_ms", 100.0, fast_window_s=2.0,
                          slow_window_s=8.0, min_count=3, clear_s=3.0)],
        registry=reg, tracer=tr, clock=clock)
    traj = []

    def ev():
        traj.append((int(mon.evaluate()),
                     mon.trackers["lat_ms"].last_burns))

    for _ in range(2):                       # a spike under the floor
        clock.advance(0.25)
        mon.observe_latency("lat_ms", 10_000.0)
        ev()
    for _ in range(6):                       # a sustained breach
        clock.advance(0.25)
        mon.observe_latency("lat_ms", 500.0)
        ev()
    for dt in (9.0, 1.0, 2.5):               # scrolls out; clear_s waits
        clock.advance(dt)
        ev()
    for i in range(4):                       # re-breach, then clear again
        clock.advance(0.25)
        mon.observe_latency("lat_ms", 50.0 if i % 2 else 150.0)
        ev()
    clock.advance(9.0)
    ev()
    return traj, reg.to_json(), tr.to_jsonl()


def _slo_error_rate(ns, tmp_path=None):
    clock = ns.clock()
    reg = ns.obs.Registry()
    tr = ns.obs.Tracer(clock=clock)
    mon = ns.obs.SloMonitor(
        [ns.obs.Objective("error_rate", 0.25, kind="error_rate",
                          fast_window_s=2.0, slow_window_s=8.0, min_count=4),
         ns.obs.Objective.parse("ttft_ms p50 < 20", fast_window_s=1.0,
                                slow_window_s=6.0, min_count=2)],
        registry=reg, tracer=tr, clock=clock)
    traj = []
    for i in range(24):
        clock.advance(0.25)
        mon.observe_event("error_rate", ok=(i % 2 == 0 or i > 12))
        mon.observe_latency("ttft_ms", 5.0 * (i % 7))
        mon.observe_latency("error_rate", 5.0)       # ignored: wrong kind
        traj.append((int(mon.evaluate()),
                     {k: (int(v), mon.trackers[k].last_burns)
                      for k, v in mon.states().items()}))
    return traj, reg.to_json(), tr.to_jsonl()


def _profile(ns, tmp_path=None):
    r = ns.obs.Registry()
    p = ns.profile.KernelProfiler(r)
    for algo in ("baseline", "fip", "ffip"):
        for dt in ("float32", "int8", "float16"):
            p.record_gemm(16, 8, 12, algo=algo, dtype=dt)
            p.record_gemm(4, 7, 9, algo=algo, dtype=dt, batch=3)
            p.record_gemm(16, 8, 12, algo=algo, dtype=dt, traced=True)
            p.record_conv(batch=2, oh=5, ow=5, cin=6, kh=3, kw=3, cout=8,
                          groups=2, algo=algo, dtype=dt)
    p.record_flash(bh=8, sq=16, sk=16, d=32, dtype="float32")
    p.record_flash(bh=8, sq=1, sk=40, d=32, dtype="float16", causal=True)
    p.record_timed("gemm", 2.5e-4, flops=1e9, algo="fip", dtype="int8")
    # the traces family's help says what a trace is on each side (a call
    # under JAX tracing, a call during CUDA graph capture)
    helps = (r.get("repro_kernel_traces_total").help, "<traces help>")
    return (r.to_prometheus().replace(*helps),
            r.to_json().replace(*helps))


def _watchdog(ns, tmp_path=None):
    r = ns.obs.Registry()
    clock = ns.clock()
    cfg = ns.watchdog.WatchdogConfig(threshold=2.0, consecutive_to_act=2,
                                     hang_timeout_s=5.0)
    fired = []
    dogs = [ns.watchdog.Watchdog(cfg, clock=clock, registry=r, loop=loop,
                                 on_straggler=lambda *a: fired.append(a))
            for loop in ("train", "serve")]
    for dog in dogs:
        for i, dt in enumerate((1.0, 1.1, 9.0, 9.5, 1.0, 30.0, 1.2)):
            clock.advance(dt)
            fired.append(dog.observe(i, dt))
    clock.advance(10.0)
    with pytest.raises(ns.watchdog.HangError):
        dogs[1].check_hang()
    return r.to_prometheus(), fired, [list(d.events) for d in dogs]


SCENARIOS = {"metrics": _metrics_mixed, "trace": _trace,
             "windows": _windows, "slo_page": _slo_page,
             "slo_error_rate": _slo_error_rate, "profile": _profile,
             "watchdog": _watchdog}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_obs_matches_reference(name, tmp_path):
    want = SCENARIOS[name](REF, tmp_path)
    got = SCENARIOS[name](PORT, tmp_path)
    assert got == want


def test_objective_dsl_matches_reference():
    for spec in ("ttft_ms p99 < 200", "itl_ms p50 < 1.5", "error_rate < 0.1"):
        assert dataclasses.asdict(obs.Objective.parse(spec)) == \
            dataclasses.asdict(jobs.Objective.parse(spec))
    for bad in ("ttft_ms 200", "p99 <", "error_rate p99 < 0.5", "x < -1",
                "ttft_ms p99 < 0"):
        with pytest.raises(ValueError):
            obs.Objective.parse(bad)


def test_analytical_matches_reference():
    """The copied Eq. 1/5/6 counts, the Fig. 2 register model, the MXU
    resource model and the cycle model over the paper's CNN workloads."""
    from repro.core import analytical as jan
    from repro.core import workloads as jwl
    from repro_torch.core import analytical as an
    from repro_torch.core import workloads as wl
    for m, k, n in ((8, 16, 4), (512, 512, 512), (3, 6, 5)):
        for fn in ("baseline_mults", "baseline_adds", "fip_mults",
                   "fip_adds"):
            assert getattr(an, fn)(m, k, n) == getattr(jan, fn)(m, k, n)
    assert an.fig2_table(x=64, d=1) == jan.fig2_table(x=64, d=1)
    for algo in ("baseline", "fip", "ffip"):
        for x, y, w in ((64, 64, 8), (32, 16, 16)):
            cfg = an.MxuConfig(x, y, algo=algo, w_bits=w)
            jcfg_ = jan.MxuConfig(x, y, algo=algo, w_bits=w)
            assert (an.mxu_multipliers(cfg), an.mxu_dsps(cfg),
                    an.mxu_fmax_mhz(cfg), an.ops_roof(cfg)) == \
                (jan.mxu_multipliers(jcfg_), jan.mxu_dsps(jcfg_),
                 jan.mxu_fmax_mhz(jcfg_), jan.ops_roof(jcfg_))
            for model in ("alexnet", "resnet50", "vgg16"):
                got = an.model_performance(getattr(wl, model)(4), cfg)
                want = jan.model_performance(getattr(jwl, model)(4), jcfg_)
                assert got == want


# -- profiler ----------------------------------------------------------------

def test_profiler_fip_multiplier_accounting():
    """Eq. 1 effective ops; Eqs. 5/7 multiplier counts (FIP/FFIP halve the
    multiplies for even K; baseline and odd K stay at m*k*n)."""
    r = Registry()
    p = obs_profile.KernelProfiler(r)
    p.record_gemm(16, 8, 12, algo="ffip", dtype="float32")
    p.record_gemm(16, 8, 12, algo="baseline", dtype="float32")

    def get(metric, algo):
        return r.get(metric).labels(kernel="gemm", algo=algo,
                                    dtype="float32").value
    assert get("repro_kernel_flops_total", "ffip") == 2880.0
    assert get("repro_kernel_mults_total", "ffip") == 880.0
    assert get("repro_kernel_mults_total", "baseline") == 1536.0
    p.record_gemm(16, 8, 12, algo="ffip", dtype="float32", traced=True)
    assert get("repro_kernel_traces_total", "ffip") == 1.0
    assert get("repro_kernel_dispatches_total", "ffip") == 1.0


@pytest.fixture
def profiler():
    prev = obs_profile.set_profiler(obs_profile.KernelProfiler(Registry()))
    on = obs_profile.enable(True)
    yield obs_profile.get_profiler()
    obs_profile.set_profiler(prev)
    obs_profile.enable(on)


def test_kernel_hooks_are_off_until_enabled():
    """The hooks count nothing until a caller turns them on (the port's run
    on every eager call, where the reference's run once a compilation);
    ``enable`` returns the previous setting."""
    from repro_torch.kernels import ops
    prev = obs_profile.set_profiler(obs_profile.KernelProfiler(Registry()))
    try:
        with torch.no_grad():
            ops.matmul(torch.ones(2, 8), torch.ones(8, 4), algo="ffip")
        lab = dict(kernel="gemm", algo="ffip", dtype="float32")
        assert obs_profile.get_profiler().dispatches.labels(**lab).value == 0
        assert obs_profile.enable(True) is False
        assert obs_profile.enable(False) is True
    finally:
        obs_profile.set_profiler(prev)


def test_kernel_hooks_count_cpu_calls_as_dispatches(profiler):
    """The real call sites: a call on CPU tensors is a dispatch (nothing on
    the CPU is a trace), labelled by torch dtype name as the reference
    labels numpy's; ``enable(False)`` stops the counting."""
    from repro_torch.kernels import conv_gemm, flash_attention, ops
    a = torch.ones(2, 16, 8)
    b = torch.ones(8, 16)
    with torch.no_grad():
        torch.testing.assert_close(ops.matmul(a, b, algo="ffip"), a @ b)
        q = torch.randn(4, 8, 16)
        flash_attention.flash_attention(q, q, q)
        conv_gemm.conv_gemm_fused(torch.randn(1, 6, 6, 4),
                                  torch.randn(3, 3, 2, 6), stride=1,
                                  groups=2, algo="fip")
    lab = dict(kernel="gemm", algo="ffip", dtype="float32")
    assert profiler.dispatches.labels(**lab).value == 1.0
    assert profiler.traces.labels(**lab).value == 0.0
    assert profiler.flops.labels(**lab).value == 2 * (16 * 8 * 16 * 2 - 16 * 16)
    assert profiler.dispatches.labels(kernel="flash", algo="dot",
                                      dtype="float32").value == 1.0
    conv = profiler.dispatches.labels(kernel="conv", algo="fip",
                                      dtype="float32")
    assert conv.value == 1.0
    obs_profile.enable(False)
    with torch.no_grad():
        ops.matmul(a, b, algo="ffip")
    assert profiler.dispatches.labels(**lab).value == 1.0


def test_compile_snapshot_names_the_missing_tuner():
    """The reference's three entries, the tuner's two filled from
    ``repro_torch.tune.stats`` and ``tune.measure.counters`` (they were
    ``{}`` before the tuner was ported), with the reference's keys."""
    from repro import tune as jtune
    from repro.tune import measure as jmeasure
    from repro_torch import tune
    from repro_torch.tune import measure
    snap = obs_profile.compile_snapshot()
    assert set(snap) == {"derived_cache", "schedule_cache", "measure"}
    assert set(snap["derived_cache"]) == {"computed", "hits", "seeded"}
    assert snap["schedule_cache"] == tune.stats
    assert snap["measure"] == measure.counters
    assert set(snap["schedule_cache"]) == set(jtune.stats)
    assert set(snap["measure"]) == set(jmeasure.counters)


# -- metrics layer -----------------------------------------------------------

def test_label_cardinality_guard_and_registration():
    r = Registry()
    for bad in ("rid", "request_id", "req_id"):
        with pytest.raises(CardinalityError):
            r.counter(f"x_{bad}_total", "t", (bad,))
    c = r.counter("caps_total", "t", ("k",))
    for i in range(c.max_label_sets):
        c.labels(k=str(i)).inc()
    with pytest.raises(CardinalityError):
        c.labels(k="one-too-many")
    with pytest.raises(ValueError, match="bind with .labels"):
        r.counter("fam_total", "t", ("phase",)).inc()
    assert r.counter("same_total", "t") is r.counter("same_total", "t")
    with pytest.raises(ValueError):
        r.gauge("same_total")


def test_metrics_http_endpoint_scrapes():
    import urllib.request
    r = Registry()
    r.counter("scrape_total").inc(7)
    srv = start_metrics_server(r, port=0)
    try:
        host, port = srv.server_address[:2]
        assert host == "127.0.0.1"
        txt = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics").read().decode()
        assert parse_prometheus(txt)["scrape_total"][()] == 7.0
        blob = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics.json").read()
        assert json.loads(blob)["scrape_total"]["series"][0]["value"] == 7.0
    finally:
        srv.shutdown()
        srv.server_close()


# -- watchdog ------------------------------------------------------------------

def test_train_watchdog_shim_cannot_diverge():
    assert StepWatchdog.observe is Watchdog.observe
    assert StepWatchdog.check_hang is Watchdog.check_hang
    assert set(vars(StepWatchdog)) <= {"__init__", "__doc__", "__module__",
                                       "__qualname__", "__firstlineno__",
                                       "__static_attributes__"}


def test_watchdog_counters_labeled_by_loop():
    r = Registry()
    clock = FakeClock()
    cfg = WatchdogConfig(threshold=2.0, consecutive_to_act=2,
                         hang_timeout_s=5.0)
    train = StepWatchdog(cfg, clock=clock, registry=r)
    serve = Watchdog(cfg, clock=clock, registry=r, loop="serve")
    for dog in (train, serve):
        dog.observe(0, 1.0)
        dog.observe(1, 10.0)
    straggler = r.get("watchdog_straggler_flags_total")
    assert straggler.labels(loop="train").value == 1.0
    assert straggler.labels(loop="serve").value == 1.0
    clock.advance(10.0)
    with pytest.raises(HangError):
        serve.check_hang()
    assert r.get("watchdog_deadman_trips_total").labels(
        loop="serve").value == 1.0
    assert len(train.events) <= train.events.maxlen


# -- serving integration -----------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    cfg = dataclasses.replace(configs.smoke_config(
        configs.get_config("minicpm-2b")), attention_impl="naive")
    model = Model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)) for n in LENS]
    return model, model.init(0), prompts


def test_batcher_clock_injection_and_fresh_stats_contract(lm):
    """Every batcher time read goes through the injected clock (a frozen
    FakeClock gives all-zero timings), and run_until_drained resets stats
    per drain while the registry stays cumulative."""
    import repro_torch.serve.batcher as batcher
    model, params, prompts = lm
    assert "perf_counter" not in inspect.getsource(batcher)
    clock = FakeClock()
    reg = Registry()
    srv = BatchServer(model, batch_slots=2, max_len=MAX_LEN, clock=clock,
                      registry=reg, device="cpu")
    srv.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=MAX_NEW,
                       eos_id=-1))
    done = srv.run_until_drained(params)
    assert len(done) == 1
    first = dict(srv.stats)
    assert first["prefill_s"] == 0.0 and first["decode_s"] == 0.0
    assert done[0].t_done == done[0].t_submit == 0.0

    srv.submit(Request(rid=1, prompt=prompts[1], max_new_tokens=MAX_NEW,
                       eos_id=-1))
    srv.run_until_drained(params)
    second = dict(srv.stats)
    assert second["prefill_tokens"] == len(prompts[1])
    assert second["decode_tokens"] == MAX_NEW - 1
    tok = reg.get("serve_tokens_total")
    assert tok.labels(replica="solo", phase="prefill").value == \
        len(prompts[0]) + len(prompts[1])
    assert tok.labels(replica="solo", phase="decode").value == \
        2 * (MAX_NEW - 1)
    e2e = reg.get("serve_request_e2e_seconds").labels(replica="solo")
    assert e2e.count == 2 and e2e.quantile(0.99) == 0.0
    assert reg.get("serve_dispatches_total").labels(
        replica="solo", phase="prefill").value == 2
    itl = reg.get("serve_itl_window_seconds").labels(replica="solo",
                                                     tier="float")
    assert itl.count() == 2 * (MAX_NEW - 1)


def test_batcher_events_ring_is_bounded(lm):
    model, params, prompts = lm
    srv = BatchServer(model, batch_slots=2, max_len=MAX_LEN, paged=True,
                      page_size=4, num_pages=24, prefill_chunk=4,
                      trace_capacity=6, device="cpu", registry=Registry())
    for i, p in enumerate(prompts):
        srv.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW,
                           eos_id=-1))
    srv.run_until_drained(params)
    assert len(srv.tracer.spans) <= 6 and srv.tracer.dropped > 0
    ev = srv.events
    assert ev, "events view empty"
    for e in ev:
        assert e[0] in ("prefill_chunk", "decode")
        if e[0] == "prefill_chunk":
            _, rid, start, end = e
            assert isinstance(rid, int) and 0 <= start < end
        else:
            assert isinstance(e[1], tuple)


def test_router_span_tree_for_retried_faulted_request(lm):
    model, params, prompts = lm
    reg = Registry()
    servers = [BatchServer(model, batch_slots=2, max_len=MAX_LEN,
                           device="cpu", registry=reg) for _ in range(2)]
    plan = FaultPlan([FaultSpec(kind="raise", replica=0, at_dispatch=0,
                                duration=2)], seed=3)
    rt = ReplicaRouter(servers, params, fault_plan=plan, clock=FakeClock(),
                       registry=reg,
                       cfg=RouterConfig(step_timeout_s=5.0, quarantine_s=0.2,
                                        max_retries=4))
    for i, p in enumerate(prompts):
        rt.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW, eos_id=-1))
    recs = rt.drive(max_ticks=2000)
    assert all(r.state is Lifecycle.DONE for r in recs.values())
    assert rt.stats["retries"] >= 1
    for rid in map(str, range(len(LENS))):
        roots = [s for s in rt.tracer.completed(rid) if s.name == "request"]
        assert len(roots) == 1 and roots[0].t1 is not None, rid
        tree = rt.tracer.span_tree(rid)
        assert tree["attrs"]["outcome"] == "done" and tree["children"]
    retried = [s.rid for s in rt.tracer.spans if s.name == "retry"]
    assert retried, "fault plan produced no retry event"
    flat = rt.tracer.span_tree(retried[0])["children"]
    kinds = [c["name"] for c in flat]
    assert kinds[0] == "queued" and "retry" in kinds
    retry = next(c for c in flat if c["name"] == "retry")
    assert retry["attrs"]["error"] == "ReplicaFailedError"
    assert {0, 1} <= {c["attrs"].get("attempt") for c in flat}
    for kind, v in rt.stats.items():
        got = reg.get("router_events_total").labels(kind=kind).value
        assert got == v, (kind, got, v)


def test_router_e2e_histogram_feeds_quantiles(lm):
    model, params, prompts = lm
    reg = Registry()
    servers = [BatchServer(model, batch_slots=2, max_len=MAX_LEN,
                           device="cpu", registry=reg)]
    rt = ReplicaRouter(servers, params, clock=FakeClock(), registry=reg,
                       cfg=RouterConfig(step_timeout_s=5.0))
    for i, p in enumerate(prompts):
        rt.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW, eos_id=-1))
    recs = rt.drive(max_ticks=2000)
    lat = sorted(r.t_done - r.t_submit for r in recs.values())
    h = reg.get("router_request_e2e_seconds")
    assert h.count == len(LENS)
    assert h.quantile(0.5) == pytest.approx(float(np.percentile(lat, 50)))
