"""The port's fault-tolerant router (``repro_torch.serve.router``) over the
port's BatchServer replicas, against the reference's.

* The fault matrix of tests/test_serve_router.py: every fault kind (raise /
  hang / exhaust / poison) x {float, int8-FFIP} x {contiguous, paged} on a
  2-replica fleet ends with every request DONE and token-identical to its
  oracle, every fault fired, bounded retries, each completion exposed once,
  and (paged) the reservation ledger drained to 0. The float oracle is the
  reference's BatchServer's tokens (computed once per module, and first
  held equal to the port's own single server); the int8 oracle is the
  port's own single server, which tests/test_torch_serve.py holds equal to
  the reference's (that keeps the reference's int8 path out of this file).
* The reference's other router cases, on the port: typed retry exhaustion,
  deadlines and phase timeouts, backpressure, fail-fast admission,
  idempotent rids, shed to int8, the circuit breaker, a quarantined
  replica's drain, hang faults needing a FakeClock, the watchdog's
  straggler, and the fault plan's JSON round trip.
* One seeded plan (raise, contiguous, float) through the reference's router
  over the reference's servers and through the port's over the port's:
  equal ``stats``, outcome counts, transition histories, events, tokens,
  span trace and metric snapshot (but ``serve_compiles_total``, a jit-trace
  count the port does not have).

attention_impl is "naive" as in the reference's tests, so paged and
contiguous runs share the same plain attention.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro_torch.obs as obs
from repro import configs as jcfg
from repro.models.model import build_model as j_build
from repro.obs import Registry as JRegistry
from repro.serve.batcher import BatchServer as JServer
from repro.serve.batcher import Request as JRequest
from repro.serve.faults import FakeClock as JFakeClock
from repro.serve.faults import FaultPlan as JFaultPlan
from repro.serve.faults import FaultSpec as JFaultSpec
from repro.serve.router import ReplicaRouter as JRouter
from repro.serve.router import RouterConfig as JRouterConfig
from repro_torch import bridge, configs
from repro_torch.launch.serve import unplanned_failures
from repro_torch.models.model import Model
from repro_torch.obs import Registry
from repro_torch.serve import lifecycle as lc
from repro_torch.serve.batcher import BatchServer, Request
from repro_torch.serve.faults import FakeClock, FaultPlan, FaultSpec
from repro_torch.serve.lifecycle import Lifecycle
from repro_torch.serve.router import (HEALTHY, QUARANTINED, ReplicaRouter,
                                      RouterConfig)
from repro_torch.watchdog import WatchdogConfig

MAX_LEN = 48
LENS = [3, 7, 5, 9, 4, 6]
MAX_NEW = 5
SLOTS = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The router cases run many small ops: one intra-op thread keeps them
    from contending with the other test workers' threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def fresh_registry():
    """Each case registers into its own default registry."""
    prev = obs.set_registry(Registry())
    yield
    obs.set_registry(prev)


@pytest.fixture(scope="module")
def ref():
    """The reference's smoke model and float oracle, and the port's model on
    the same weights."""
    jc = dataclasses.replace(jcfg.smoke_config(jcfg.get_config("minicpm-2b")),
                             attention_impl="naive")
    jm = j_build(jc)
    jparams = jm.init(jax.random.PRNGKey(0))
    srv = JServer(jm, batch_slots=SLOTS, max_len=MAX_LEN)
    for i, p in enumerate(_prompts(jc.vocab)):
        srv.submit(JRequest(rid=i, prompt=p, max_new_tokens=MAX_NEW,
                            eos_id=-1))
    want = {r.rid: list(r.out_tokens) for r in srv.run_until_drained(jparams)}
    cfg = dataclasses.replace(configs.smoke_config(
        configs.get_config("minicpm-2b")), attention_impl="naive")
    model = Model(cfg, device="cpu")
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return dict(jm=jm, jparams=jparams, model=model, params=params,
                vocab=cfg.vocab, oracle={False: want})


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)) for n in LENS]


def _single(ref, quantized):
    """The port's no-fault single server's tokens."""
    srv = BatchServer(ref["model"], batch_slots=SLOTS, max_len=MAX_LEN,
                      quantized=quantized, device="cpu")
    for i, p in enumerate(_prompts(ref["vocab"])):
        srv.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW,
                           eos_id=-1))
    return {r.rid: list(r.out_tokens)
            for r in srv.run_until_drained(ref["params"])}


def _oracle(ref, quantized):
    if quantized not in ref["oracle"]:
        ref["oracle"][quantized] = _single(ref, quantized)
    return ref["oracle"][quantized]


def _fleet(ref, n, *, quantized=False, paged=False, slots=SLOTS):
    kw = dict(paged=True, page_size=4, num_pages=24) if paged else {}
    if isinstance(quantized, bool):
        quantized = [quantized] * n
    return [BatchServer(ref["model"], batch_slots=slots, max_len=MAX_LEN,
                        quantized=q, device="cpu", **kw)
            for q in quantized], ref["params"]


def _submit_all(rt, vocab, **kw):
    for i, p in enumerate(_prompts(vocab)):
        rt.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW,
                          eos_id=-1), **kw)


# the reference's plans: each kind FIRES against this workload (asserted)
_PLANS = {
    "raise": FaultPlan([FaultSpec(kind="raise", replica=0, at_dispatch=1,
                                  duration=2)], seed=3),
    "hang": FaultPlan([FaultSpec(kind="hang", replica=0, at_dispatch=1,
                                 duration=2)], seed=3),
    "exhaust": FaultPlan([FaultSpec(kind="exhaust", replica=0,
                                    at_dispatch=0, duration=3)], seed=3),
    "poison": FaultPlan([FaultSpec(kind="poison", replica=0, at_dispatch=0,
                                   duration=8)], seed=3),
}


def test_port_float_oracle_matches_reference(ref):
    """The float oracle below is the reference's tokens: the port's own
    single server gives them too."""
    assert _single(ref, False) == ref["oracle"][False]


@pytest.mark.parametrize("kind", sorted(_PLANS))
@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_fault_matrix_completes_token_identical(ref, kind, paged, quantized):
    want = _oracle(ref, quantized)
    servers, params = _fleet(ref, 2, quantized=quantized, paged=paged)
    rt = ReplicaRouter(servers, params,
                       cfg=RouterConfig(step_timeout_s=5.0,
                                        quarantine_s=0.2, max_retries=4),
                       fault_plan=_PLANS[kind], clock=FakeClock())
    _submit_all(rt, ref["vocab"])
    recs = rt.drive(max_ticks=2000)

    assert all(r.terminal for r in recs.values())
    toks = rt.completed_tokens()
    assert sorted(toks) == list(range(len(LENS))), rt.outcome_counts()
    for i, t in toks.items():
        assert t == want[i], (kind, paged, quantized, i)
    assert rt.stats["replica_failures"] + rt.stats["poisoned"] >= 1, rt.stats
    assert unplanned_failures(rt.events) == []
    assert all(r.attempts <= rt.cfg.max_retries for r in recs.values())
    assert rt.stats["completed"] == len(LENS)
    for s in servers:
        if s.paged:
            assert s._reserved == 0
            assert s.alloc.free_count + s.alloc.in_use == s.num_pages


@pytest.mark.parametrize("error, paged", [
    (torch.OutOfMemoryError("CUDA out of memory"), True),
    (RuntimeError("kernel launch failed"), False),
], ids=["oom-on-drained-pool", "runtime-error-contiguous"])
def test_unplanned_replica_failure_is_flagged(ref, error, paged):
    """A replica step that raises what the plan did not inject is absorbed
    by the router as a failover (every request still ends DONE), and
    ``launch.serve.unplanned_failures`` names it: an out-of-memory error
    even on the replica whose pool the exhaust fault holds, a
    ``RuntimeError`` on a replica with no page pool to drain."""
    servers, params = _fleet(ref, 2, paged=paged)
    step, calls = servers[1].step, []

    def failing(p):
        calls.append(1)
        if len(calls) == 2:
            raise error
        return step(p)
    servers[1].step = failing
    rt = ReplicaRouter(servers, params,
                       cfg=RouterConfig(step_timeout_s=5.0,
                                        quarantine_s=0.2, max_retries=4),
                       fault_plan=_PLANS["exhaust"], clock=FakeClock())
    _submit_all(rt, ref["vocab"])
    rt.drive(max_ticks=2000)
    assert rt.outcome_counts() == {"done": len(LENS)}
    name = type(error).__name__
    got = unplanned_failures(rt.events)
    assert len(got) == 1 and f"replica 1 step raised {name}" in got[0], got
    planned = [e for e in rt.events
               if e[0] == "replica_failure" and e[1] == 0]
    assert planned                      # the plan's own failures pass
    assert unplanned_failures(
        [e for e in rt.events if not (e[0] == "replica_failure"
                                      and e[1] == 1)]) == []
    assert unplanned_failures([("replica_failure", 0, 3, "RuntimeError")]) \
        != []                           # outside an exhaust window


def _run_pair(ref, *, port: bool):
    """One seeded plan (raise, contiguous, float) through one side's router
    and servers, each side on its own registry and FakeClock."""
    if port:
        reg, clock = Registry(), FakeClock()
        servers = [BatchServer(ref["model"], batch_slots=SLOTS,
                               max_len=MAX_LEN, device="cpu", registry=reg,
                               clock=clock) for _ in range(2)]
        plan = FaultPlan([FaultSpec(kind="raise", replica=0, at_dispatch=1,
                                    duration=2)], seed=3)
        rt = ReplicaRouter(servers, ref["params"], fault_plan=plan,
                           clock=clock, registry=reg,
                           cfg=RouterConfig(step_timeout_s=5.0,
                                            quarantine_s=0.2, max_retries=4))
        req = Request
    else:
        reg, clock = JRegistry(), JFakeClock()
        servers = [JServer(ref["jm"], batch_slots=SLOTS, max_len=MAX_LEN,
                           registry=reg, clock=clock) for _ in range(2)]
        plan = JFaultPlan([JFaultSpec(kind="raise", replica=0,
                                      at_dispatch=1, duration=2)], seed=3)
        rt = JRouter(servers, ref["jparams"], fault_plan=plan, clock=clock,
                     registry=reg,
                     cfg=JRouterConfig(step_timeout_s=5.0, quarantine_s=0.2,
                                       max_retries=4))
        req = JRequest
    for i, p in enumerate(_prompts(ref["vocab"])):
        rt.submit(req(rid=i, prompt=p, max_new_tokens=MAX_NEW, eos_id=-1))
    recs = rt.drive(max_ticks=2000)
    snap = reg.snapshot()
    snap.pop("serve_compiles_total", None)
    return dict(
        stats=dict(rt.stats), outcomes=rt.outcome_counts(),
        history={rid: list(r.history) for rid, r in recs.items()},
        attempts={rid: r.attempts for rid, r in recs.items()},
        tiers={rid: r.tier for rid, r in recs.items()},
        tokens=rt.completed_tokens(), events=list(rt.events),
        trace=rt.tracer.to_jsonl(),
        metrics=json.dumps(snap, sort_keys=True))


def test_router_matches_reference_router_on_a_seeded_plan(ref):
    want = _run_pair(ref, port=False)
    got = _run_pair(ref, port=True)
    assert want["stats"]["retries"] >= 1          # the plan fired
    for key in want:
        assert got[key] == want[key], key


def test_retries_exhausted_is_typed_and_bounded(ref):
    plan = FaultPlan([FaultSpec(kind="raise", replica=0, at_dispatch=0,
                                duration=10_000)])
    servers, params = _fleet(ref, 1)
    rt = ReplicaRouter(servers, params,
                       cfg=RouterConfig(max_retries=2, quarantine_s=0.05,
                                        step_timeout_s=5.0,
                                        breaker_threshold=10**6),
                       fault_plan=plan, clock=FakeClock())
    _submit_all(rt, ref["vocab"])
    recs = rt.drive(max_ticks=2000)
    for rec in recs.values():
        assert rec.state is Lifecycle.FAILED
        assert isinstance(rec.error, lc.RetriesExhaustedError)
        assert rec.error.attempts == 3
        assert isinstance(rec.error.cause, lc.ReplicaFailedError)


def test_deadline_and_phase_timeouts(ref):
    servers, params = _fleet(ref, 1, slots=1)
    rt = ReplicaRouter(servers, params, clock=FakeClock(),
                       cfg=RouterConfig(tick_s=0.01,
                                        phase_timeouts_s={"queued": 0.02}))
    prompts = _prompts(ref["vocab"])
    rt.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=MAX_NEW,
                      eos_id=-1))
    rt.submit(Request(rid=1, prompt=prompts[1], max_new_tokens=MAX_NEW,
                      eos_id=-1), deadline_s=0.005)
    for i in (2, 3, 4):
        rt.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=MAX_NEW,
                          eos_id=-1))
    recs = rt.drive(max_ticks=2000)
    assert recs[0].state is Lifecycle.DONE
    assert recs[0].tokens == _oracle(ref, False)[0]
    assert recs[1].state is Lifecycle.TIMED_OUT
    assert isinstance(recs[1].error, lc.DeadlineExceededError)
    assert recs[1].error.phase == "queued"
    timed_out = [i for i in (2, 3, 4)
                 if recs[i].state is Lifecycle.TIMED_OUT]
    assert timed_out, "queued-phase timeout never fired"
    for i in timed_out:
        assert isinstance(recs[i].error, lc.DeadlineExceededError)
    assert rt.stats["timed_out"] == len(timed_out) + 1


def test_backpressure_bounded_queue_rejects_with_retry_hint(ref):
    servers, params = _fleet(ref, 1, slots=1)
    rt = ReplicaRouter(servers, params, cfg=RouterConfig(max_queue=2),
                       clock=FakeClock())
    prompts = _prompts(ref["vocab"])
    rt.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=2, eos_id=-1))
    rt.submit(Request(rid=1, prompt=prompts[1], max_new_tokens=2, eos_id=-1))
    with pytest.raises(lc.RejectedError) as ei:
        rt.submit(Request(rid=2, prompt=prompts[2], max_new_tokens=2,
                          eos_id=-1))
    assert ei.value.retry_after_s > 0
    assert rt.stats["rejected"] == 1
    recs = rt.drive(max_ticks=2000)
    assert recs[0].state is Lifecycle.DONE
    assert recs[1].state is Lifecycle.DONE


def test_admission_impossible_fails_fast_at_router(ref):
    servers, params = _fleet(ref, 2, paged=True)
    rt = ReplicaRouter(servers, params, clock=FakeClock())
    big = np.zeros((MAX_LEN + 10,), np.int64)
    with pytest.raises(lc.AdmissionImpossibleError):
        rt.submit(Request(rid=0, prompt=big, max_new_tokens=4, eos_id=-1))
    assert not rt.records


def test_router_idempotent_duplicate_rids(ref):
    servers, params = _fleet(ref, 1)
    rt = ReplicaRouter(servers, params, clock=FakeClock())
    prompts = _prompts(ref["vocab"])
    rec = rt.submit(Request(rid=0, prompt=prompts[0],
                            max_new_tokens=MAX_NEW, eos_id=-1))
    dup = Request(rid=0, prompt=prompts[0], max_new_tokens=MAX_NEW,
                  eos_id=-1)
    assert rt.submit(dup) is rec
    assert rt.stats["dedup_submits"] == 1
    assert rt.stats["submitted"] == 1
    rt.drive(max_ticks=2000)
    dispatched = rt.stats["dispatched"]
    again = rt.submit(Request(rid=0, prompt=prompts[0],
                              max_new_tokens=MAX_NEW, eos_id=-1))
    assert again.state is Lifecycle.DONE
    assert again.tokens == _oracle(ref, False)[0]
    assert rt.stats["dispatched"] == dispatched
    with pytest.raises(lc.AdmissionImpossibleError):
        rt.submit(Request(rid=0, prompt=prompts[1], max_new_tokens=MAX_NEW,
                          eos_id=-1))


def test_shed_to_quantized_under_pressure(ref):
    servers, params = _fleet(ref, 2, quantized=[False, True], slots=1)
    rt = ReplicaRouter(servers, params, clock=FakeClock(),
                       cfg=RouterConfig(shed_queue_depth=2))
    _submit_all(rt, ref["vocab"])
    recs = rt.drive(max_ticks=2000)
    assert all(r.state is Lifecycle.DONE for r in recs.values())
    assert rt.stats["shed_to_quantized"] >= 1
    assert {rec.tier for rec in recs.values()} == {"float", "int8"}
    for rid, rec in recs.items():
        assert rec.tokens == _oracle(ref, rec.tier == "int8")[rid]


def test_circuit_breaker_quarantine_probe_readmission(ref):
    plan = FaultPlan([FaultSpec(kind="raise", replica=0, at_dispatch=0,
                                duration=3)])
    servers, params = _fleet(ref, 2, slots=1)
    rt = ReplicaRouter(servers, params, clock=FakeClock(),
                       cfg=RouterConfig(breaker_threshold=3,
                                        quarantine_s=0.02, max_retries=5,
                                        step_timeout_s=5.0),
                       fault_plan=plan)
    _submit_all(rt, ref["vocab"])
    recs = rt.drive(max_ticks=2000)
    assert all(r.state is Lifecycle.DONE for r in recs.values())
    kinds = [e[0] for e in rt.events]
    assert "quarantine" in kinds and "probe" in kinds
    assert rt.stats["quarantines"] >= 1
    assert rt.stats["probes"] >= 1
    assert rt.stats["probe_successes"] >= 1
    assert rt.replicas[0].state == HEALTHY
    want = _oracle(ref, False)
    assert all(t == want[i] for i, t in rt.completed_tokens().items())


def test_quarantined_replica_drains_work_to_queue(ref):
    plan = FaultPlan([FaultSpec(kind="raise", replica=0, at_dispatch=0,
                                duration=10_000)])
    servers, params = _fleet(ref, 2)
    rt = ReplicaRouter(servers, params, clock=FakeClock(),
                       cfg=RouterConfig(breaker_threshold=1,
                                        quarantine_s=1000.0, max_retries=4,
                                        step_timeout_s=5.0),
                       fault_plan=plan)
    _submit_all(rt, ref["vocab"])
    recs = rt.drive(max_ticks=2000)
    assert rt.replicas[0].state == QUARANTINED
    assert not rt.replicas[0].outstanding
    want = _oracle(ref, False)
    for rid, rec in recs.items():
        assert rec.state is Lifecycle.DONE
        assert rec.tokens == want[rid]


def test_hang_faults_require_fake_clock(ref):
    servers, params = _fleet(ref, 1)
    plan = FaultPlan([FaultSpec(kind="hang", replica=0, at_dispatch=0)])
    with pytest.raises(ValueError, match="FakeClock"):
        ReplicaRouter(servers, params, fault_plan=plan)


def test_watchdog_sees_hung_replica_as_straggler(ref):
    plan = FaultPlan([FaultSpec(kind="hang", replica=0, at_dispatch=2)])
    servers, params = _fleet(ref, 2)
    rt = ReplicaRouter(servers, params, clock=FakeClock(), fault_plan=plan,
                       cfg=RouterConfig(step_timeout_s=5.0, max_retries=4),
                       watchdog_cfg=WatchdogConfig(consecutive_to_act=1))
    _submit_all(rt, ref["vocab"])
    rt.drive(max_ticks=2000)
    assert any(e[0] == "straggler_tick" for e in rt.events)


def test_fault_plan_roundtrip_and_parse():
    plan = FaultPlan.flaky_replica(0, start=2, period=4, rounds=3, seed=7)
    back = FaultPlan.parse(plan.to_json())
    assert back.faults == plan.faults
    assert back.seed == 7
    assert plan.has_hangs
    # the same JSON as the reference's, both ways
    jplan = JFaultPlan.flaky_replica(0, start=2, period=4, rounds=3, seed=7)
    assert plan.to_json() == jplan.to_json()
    with pytest.raises(ValueError):
        FaultSpec(kind="meteor", replica=0, at_dispatch=0)
    clock = FakeClock()
    clock.advance(1.5)
    assert clock() == 1.5
    with pytest.raises(ValueError):
        clock.advance(-1.0)


def test_output_sanity_error_matches_reference():
    from repro.serve import lifecycle as jlc
    cases = [([], 4, -1), ([1, 2, 3, 4, 5], 4, -1), ([1, 600], 4, -1),
             ([1, 2], 4, -1), ([1, 2], 4, 2), ([1, 2, 3, 4], 4, -1)]
    for toks, max_new, eos in cases:
        assert lc.output_sanity_error(
            toks, vocab=512, max_new=max_new, eos_id=eos) == \
            jlc.output_sanity_error(toks, vocab=512, max_new=max_new,
                                    eos_id=eos)
