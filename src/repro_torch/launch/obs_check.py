"""CI gate for the repro_torch.obs telemetry files a serving run leaves
behind; a copy of ``repro/launch/obs_check.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm-2b \
        --smoke --device cpu \
        --replicas 2 --fault-plan flaky \
        --metrics-json /tmp/m.json --trace-out /tmp/t.jsonl
    PYTHONPATH=src python -m repro_torch.launch.obs_check \
        --metrics-json /tmp/m.json --trace /tmp/t.jsonl \
        --replicas 2 --requests 8 --min-retries 1

Checks (each failure is listed; exit 1 if any):
  * every replica 0..N-1 recorded NONZERO prefill and decode dispatches
    (``serve_dispatches_total{replica,phase}``) — a silent replica means the
    router never actually spread load, or the metrics plumbing is dead;
  * router accounting closes: ``submitted`` == ``--requests``, ``completed``
    == ``--requests`` (unless ``--allow-failures``), ``retries`` >=
    ``--min-retries`` (the fault plan's injected failures must be VISIBLE in
    telemetry, not just survived);
  * the trace parses and every rid 0..R-1 reconstructs to ONE complete span
    tree: a single ``request`` root, ended (t1 set), with at least one child
    phase span;
  * with ``--expect-slo NAME``: the SLO loop closed — ``slo_state{slo=NAME}``
    exists, at least ``--min-alerts`` transitions fired
    (``slo_transitions_total``), the trace carries ``slo_alert`` and
    ``controller`` point events, and every action listed in
    ``--expect-controller`` was counted in ``router_controller_total``;
    ``--expect-recovery`` additionally requires the final state back at
    OK/healthy (burn recovered, controller walked back down the ladder).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from repro_torch.obs.trace import load_jsonl, tree_from_spans


def _series_value(metrics: dict, name: str, **labels) -> float:
    """Sum of every series of ``name`` whose labels include ``labels``."""
    fam = metrics.get(name)
    if not fam:
        return 0.0
    total = 0.0
    for s in fam["series"]:
        if all(s["labels"].get(k) == v for k, v in labels.items()):
            total += s.get("value", s.get("count", 0.0))
    return total


def check_metrics(payload: dict, *, replicas: int, requests: int,
                  min_retries: int, allow_failures: bool) -> List[str]:
    problems: List[str] = []
    metrics = payload.get("metrics", payload)   # tolerate a bare snapshot
    for i in range(replicas):
        for phase in ("prefill", "decode"):
            v = _series_value(metrics, "serve_dispatches_total",
                              replica=str(i), phase=phase)
            if v <= 0:
                problems.append(f"replica {i}: zero {phase} dispatches "
                                f"recorded")
    ev = {k: _series_value(metrics, "router_events_total", kind=k)
          for k in ("submitted", "completed", "retries", "replica_failures")}
    if ev["submitted"] != requests:
        problems.append(f"router submitted {ev['submitted']:.0f} != "
                        f"--requests {requests}")
    if not allow_failures and ev["completed"] != requests:
        problems.append(f"router completed {ev['completed']:.0f} != "
                        f"--requests {requests}")
    if ev["retries"] < min_retries:
        problems.append(f"router retries {ev['retries']:.0f} < --min-retries "
                        f"{min_retries} (fault plan not visible in "
                        f"telemetry)")
    if min_retries and ev["replica_failures"] <= 0:
        problems.append("retries expected but zero replica_failures "
                        "recorded")
    return problems


def check_slo(payload: dict, trace_path: str, *, slos: List[str],
              min_alerts: int, controller_actions: List[str],
              expect_recovery: bool) -> List[str]:
    """The closed-loop gate: breach -> alert -> controller action (->
    recovery) must all be VISIBLE in the metrics snapshot and the trace."""
    problems: List[str] = []
    metrics = payload.get("metrics", payload)
    for name in slos:
        if not any(s["labels"].get("slo") == name
                   for s in metrics.get("slo_state", {}).get("series", [])):
            problems.append(f"slo {name}: no slo_state series recorded")
            continue
        fired = _series_value(metrics, "slo_transitions_total", slo=name)
        if fired < min_alerts:
            problems.append(f"slo {name}: {fired:.0f} alert transitions < "
                            f"--min-alerts {min_alerts}")
        if expect_recovery:
            final = _series_value(metrics, "slo_state", slo=name)
            if final != 0:
                problems.append(f"slo {name}: final state {final:.0f} != OK "
                                f"(burn never recovered)")
    for action in controller_actions:
        if _series_value(metrics, "router_controller_total",
                         action=action) <= 0:
            problems.append(f"controller action {action!r} never counted in "
                            f"router_controller_total")
    if expect_recovery and controller_actions:
        if _series_value(metrics, "router_controller_state") != 0:
            problems.append("router_controller_state != healthy at exit")
    if trace_path.endswith(".jsonl"):
        try:
            spans = load_jsonl(trace_path)
        except Exception as e:                          # noqa: BLE001
            return problems + [f"trace unreadable for slo events: {e}"]
        names = {s.name for s in spans}
        if slos and "slo_alert" not in names:
            problems.append("no slo_alert events in the trace")
        if controller_actions and "controller" not in names:
            problems.append("no controller events in the trace")
    return problems


def check_trace(path: str, *, requests: int) -> List[str]:
    problems: List[str] = []
    if not path.endswith(".jsonl"):
        try:
            with open(path) as f:
                doc = json.load(f)
            n = len(doc.get("traceEvents", []))
        except Exception as e:                          # noqa: BLE001
            return [f"chrome trace unreadable: {e}"]
        if n == 0:
            problems.append("chrome trace has no events")
        return problems

    try:
        spans = load_jsonl(path)
    except Exception as e:                              # noqa: BLE001
        return [f"trace unreadable: {e}"]
    by_rid: Dict[str, int] = {}
    for s in spans:
        if s.rid is not None:
            by_rid[s.rid] = by_rid.get(s.rid, 0) + 1
    for rid in (str(r) for r in range(requests)):
        roots = [s for s in spans if s.rid == rid and s.name == "request"]
        if len(roots) != 1:
            problems.append(f"rid {rid}: {len(roots)} 'request' root spans "
                            f"(want exactly 1)")
            continue
        if roots[0].t1 is None:
            problems.append(f"rid {rid}: request root never ended")
        tree = tree_from_spans(spans, rid)
        if tree is None or tree["name"] != "request":
            problems.append(f"rid {rid}: span tree did not reconstruct")
        elif not tree["children"]:
            problems.append(f"rid {rid}: request tree has no phase children")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--metrics-json", required=True)
    ap.add_argument("--trace", required=True)
    ap.add_argument("--replicas", type=int, required=True)
    ap.add_argument("--requests", type=int, required=True)
    ap.add_argument("--min-retries", type=int, default=0,
                    help="fault plans must surface at least this many "
                         "retries in router_events_total")
    ap.add_argument("--allow-failures", action="store_true",
                    help="don't require completed == requests (deadline "
                         "runs legitimately time requests out)")
    ap.add_argument("--expect-slo", action="append", default=[],
                    metavar="NAME",
                    help="require the SLO loop closed for this objective "
                         "(repeatable): slo_state series + alert "
                         "transitions + slo_alert trace events")
    ap.add_argument("--min-alerts", type=int, default=1,
                    help="min alert transitions per --expect-slo objective")
    ap.add_argument("--expect-controller", default=None, metavar="A,B,...",
                    help="comma list of degradation-controller actions that "
                         "must appear in router_controller_total "
                         "(e.g. tighten,probe,recover)")
    ap.add_argument("--expect-recovery", action="store_true",
                    help="require final slo_state == OK and the controller "
                         "back at healthy (the full closed loop)")
    args = ap.parse_args(argv)

    with open(args.metrics_json) as f:
        payload = json.load(f)
    problems = check_metrics(payload, replicas=args.replicas,
                             requests=args.requests,
                             min_retries=args.min_retries,
                             allow_failures=args.allow_failures)
    problems += check_trace(args.trace, requests=args.requests)
    actions = ([a for a in args.expect_controller.split(",") if a]
               if args.expect_controller else [])
    if args.expect_slo or actions:
        problems += check_slo(payload, args.trace, slos=args.expect_slo,
                              min_alerts=args.min_alerts,
                              controller_actions=actions,
                              expect_recovery=args.expect_recovery)
    if problems:
        print("obs-check FAIL:\n  " + "\n  ".join(problems), file=sys.stderr)
        return 1
    extras = ""
    if args.expect_slo:
        extras = (f", slo loop closed for {args.expect_slo}"
                  + (" with recovery" if args.expect_recovery else ""))
    print(f"obs-check OK: {args.replicas} replicas active, "
          f"{args.requests} span trees complete{extras}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
