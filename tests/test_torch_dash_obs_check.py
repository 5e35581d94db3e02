"""The port's ``launch.dash`` and ``launch.obs_check`` against the
reference's, and the closed SLO loop through the port's serve launcher.

* ``dash.render`` of the snapshot tests/test_dash.py builds, built once by
  each package's Registry: the same frame, with every section present.
* The launcher on the CPU at the smoke config, ``--replicas 2
  --quantized-replicas 1 --fault-plan flaky --slo "ttft_ms p99 < 2000"``
  (the reference README's loop): every request DONE with its tier's
  no-fault tokens, the controller through tighten, probe and recover; the
  port's ``obs_check`` and the reference's pass on the files it wrote, and
  both list the same problems once the files are damaged.
"""
import contextlib
import io
import json

import pytest

import repro_torch.obs as obs
from repro.launch import dash as jdash
from repro.launch import obs_check as jcheck
from repro.obs import Registry as JRegistry
from repro.serve.faults import FakeClock as JFakeClock
from repro_torch.launch import dash, obs_check
from repro_torch.launch import serve as launch
from repro_torch.obs import Registry
from repro_torch.serve.faults import FakeClock


def _snapshot(registry_cls, clock_cls):
    """tests/test_dash.py's miniature fleet snapshot."""
    clock = clock_cls()
    r = registry_cls()
    r.gauge("slo_state", labels=("slo",)).labels(slo="ttft_ms").set(2)
    b = r.gauge("slo_burn_rate", labels=("slo", "window"))
    b.labels(slo="ttft_ms", window="fast").set(5.0)
    b.labels(slo="ttft_ms", window="slow").set(1.2)
    r.counter("slo_transitions_total", labels=("slo", "to")).labels(
        slo="ttft_ms", to="PAGE").inc()
    r.gauge("router_controller_state").set(3)
    r.gauge("router_admission_limit").set(16)
    r.counter("router_controller_total", labels=("action",)).labels(
        action="tighten").inc()
    d = r.counter("serve_dispatches_total", labels=("replica", "phase"))
    d.labels(replica="0", phase="prefill").inc(4)
    d.labels(replica="0", phase="decode").inc(9)
    r.counter("serve_tokens_total", labels=("replica", "phase")).labels(
        replica="0", phase="decode").inc(36)
    r.gauge("router_replica_state", labels=("replica",)).labels(
        replica="0").set(2)
    w = r.windowed_histogram("serve_ttft_window_seconds", "t",
                             ("replica", "tier"), window_s=30.0,
                             clock=clock)
    clock.t = 0.5
    for v in (0.002, 0.004):
        w.labels(replica="0", tier="float").observe(v)
    ev = r.counter("router_events_total", labels=("kind",))
    ev.labels(kind="submitted").inc(6)
    ev.labels(kind="completed").inc(5)
    ev.labels(kind="shed_to_quantized").inc(2)
    r.gauge("router_queue_depth").set(1)
    return r.snapshot()


def test_render_matches_reference_with_all_sections():
    snap = _snapshot(Registry, FakeClock)
    assert snap == _snapshot(JRegistry, JFakeClock)
    out = dash.render(snap, source="unit")
    assert out == jdash.render(snap, source="unit")
    assert "repro.serve dashboard — unit" in out
    assert "ttft_ms" in out and "[PAGE]" in out and "5.00" in out
    assert "controller: tightened" in out
    assert "admission_limit=16" in out and "tighten=1" in out
    assert "quarantined" in out and "decode_tokens=36" in out
    assert "p50     3.00ms" in out and "n=2" in out
    assert "submitted=6" in out and "shed_to_quantized=2" in out
    assert "queue_depth=1" in out


def test_render_tolerates_launcher_payload_and_empty_snapshot():
    snap = _snapshot(Registry, FakeClock)
    assert dash.render({"metrics": snap, "compile": {}}) == dash.render(snap)
    out = dash.render({})
    assert out.startswith("repro.serve dashboard")
    assert "controller" not in out


def test_burn_bar_clamps():
    for frac, want in ((0.0, "...."), (0.5, "##.."), (7.0, "####"),
                       (-1.0, "....")):
        assert dash._bar(frac, 4) == want == jdash._bar(frac, 4)


SLO_ARGS = ["--arch", "minicpm-2b", "--smoke", "--device", "cpu",
            "--slots", "2", "--requests", "8", "--max-new", "4",
            "--replicas", "2", "--quantized-replicas", "1",
            "--fault-plan", "flaky", "--slo", "ttft_ms p99 < 2000",
            "--slo-windows", "2,8", "--slo-min-count", "2",
            "--slo-drain-ticks", "1600"]
CHECK_ARGS = ["--replicas", "2", "--requests", "8", "--min-retries", "1",
              "--expect-slo", "ttft_ms", "--expect-controller",
              "tighten,probe,recover", "--expect-recovery"]


@pytest.fixture(scope="module")
def slo_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("slo")
    m, t = str(d / "metrics.json"), str(d / "trace.jsonl")
    out = io.StringIO()
    before = obs.get_registry()
    with contextlib.redirect_stdout(out):
        launch.main(SLO_ARGS + ["--metrics-json", m, "--trace-out", t,
                                "--metrics-port", "0"])
    # the run's registry (which holds its router) is not left as the
    # default, nor the kernel hooks it turned on
    assert obs.get_registry() is before
    assert obs.profile.enable(False) is False
    return m, t, out.getvalue()


def test_launcher_closes_the_slo_loop_on_cpu(slo_run):
    m, t, out = slo_run
    assert out.rstrip().endswith("OK")
    assert "8/8 done" in out and "outcomes {'done': 8}" in out
    assert "slo: states={'ttft_ms': 'OK'} controller=healthy" in out
    assert "metrics: http://127.0.0.1:" in out
    payload = json.load(open(m))
    assert set(payload["compile"]) == {"derived_cache", "schedule_cache",
                                       "measure"}
    ctl = {s["labels"]["action"]: s["value"] for s in
           payload["metrics"]["router_controller_total"]["series"]}
    assert all(ctl.get(a, 0) >= 1 for a in ("tighten", "probe", "recover"))
    # --metrics-json turned the kernel hooks on for the run (the smoke
    # run's GEMMs are torch.matmul; its prefill goes through flash)
    hooks = payload["metrics"]["repro_kernel_dispatches_total"]["series"]
    assert sum(s["value"] for s in hooks) > 0


@pytest.mark.parametrize("checker", [obs_check, jcheck],
                         ids=["port", "reference"])
def test_obs_check_passes_on_the_launcher_files(slo_run, checker, capsys):
    m, t, _ = slo_run
    assert checker.main(["--metrics-json", m, "--trace", t]
                        + CHECK_ARGS) == 0
    assert "obs-check OK" in capsys.readouterr().out


def test_obs_check_flags_damaged_files_as_the_reference(slo_run, tmp_path):
    m, t, _ = slo_run
    payload = json.load(open(m))
    fam = payload["metrics"]["serve_dispatches_total"]
    fam["series"] = [s for s in fam["series"]
                     if s["labels"]["replica"] != "1"]
    for s in payload["metrics"]["router_controller_total"]["series"]:
        if s["labels"]["action"] == "recover":
            s["value"] = 0
    bad_m = tmp_path / "m.json"
    bad_m.write_text(json.dumps(payload))
    lines = open(t).read().splitlines()
    bad_t = tmp_path / "t.jsonl"
    bad_t.write_text("\n".join(
        ln for ln in lines
        if not (json.loads(ln).get("rid") == "3"
                and json.loads(ln)["name"] == "request")) + "\n")
    kw = dict(replicas=2, requests=8, min_retries=1, allow_failures=False)
    got = obs_check.check_metrics(payload, **kw)
    assert got == jcheck.check_metrics(payload, **kw)
    assert any("replica 1: zero prefill" in p for p in got)
    got = obs_check.check_trace(str(bad_t), requests=8)
    assert got == jcheck.check_trace(str(bad_t), requests=8)
    assert got == ["rid 3: 0 'request' root spans (want exactly 1)"]
    slo_kw = dict(slos=["ttft_ms"], min_alerts=1,
                  controller_actions=["tighten", "probe", "recover"],
                  expect_recovery=True)
    got = obs_check.check_slo(payload, str(bad_t), **slo_kw)
    assert got == jcheck.check_slo(payload, str(bad_t), **slo_kw)
    assert any("'recover' never counted" in p for p in got)
    assert obs_check.main(["--metrics-json", str(bad_m), "--trace",
                           str(bad_t)] + CHECK_ARGS) == 1


def test_dash_cli_renders_the_launcher_dump(slo_run, capsys):
    m, _, _ = slo_run
    assert dash.main(["--file", m, "--frames", "1", "--no-clear"]) == 0
    out = capsys.readouterr().out
    assert "controller: healthy" in out and "r0" in out and "r1" in out
    snap = json.load(open(m))
    assert dash.render(snap, source=m) == jdash.render(snap, source=m)


def test_slo_needs_replicas():
    with pytest.raises(SystemExit):
        launch.main(["--arch", "minicpm-2b", "--smoke", "--device", "cpu",
                     "--slo", "ttft_ms p99 < 2000"])
