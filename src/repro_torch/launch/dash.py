"""Live terminal dashboard over the repro_torch.obs metrics snapshot (stdlib
only); a copy of ``repro/launch/dash.py``, which renders the same frame
from the same snapshot (its title included).

    # live, against a serving fleet exporting /metrics.json:
    PYTHONPATH=src python -m repro_torch.launch.serve ... --metrics-port 9400 &
    PYTHONPATH=src python -m repro_torch.launch.dash --url http://127.0.0.1:9400

    # one frame from a --metrics-json dump (CI smoke / post-mortem):
    PYTHONPATH=src python -m repro_torch.launch.dash --file /tmp/m.json --frames 1

Renders, from nothing but the registry snapshot (so it works identically
against a live scrape endpoint, a dumped file, or an in-process registry):

  * SLO burn gauges — per objective: alert state (OK/WARN/PAGE), fast/slow
    burn rates as bars, and the alert-transition counts;
  * the degradation controller — state ladder position and effective
    admission limit, plus every counted controller action;
  * replica health — circuit-breaker state (healthy/probing/quarantined)
    and per-replica dispatch/e2e numbers;
  * windowed percentiles — sliding-window TTFT / inter-token latency per
    {replica, tier} from ``serve_*_window_seconds`` (and the router-level
    ``router_ttft_ms_window``);
  * router totals (``router_events_total``) and queue depth.

``render(snapshot)`` is a pure function of the snapshot dict — the tests
drive it directly; the CLI just polls and repaints.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request
from typing import Dict, List, Optional

_CLEAR = "\x1b[2J\x1b[H"
_REPLICA_STATE = {0: "healthy", 1: "probing", 2: "quarantined"}
_CTL_STATE = {0: "healthy", 1: "probing", 2: "degraded", 3: "tightened"}
_ALERT = {0: "OK", 1: "WARN", 2: "PAGE"}


def _bar(frac: float, width: int = 20) -> str:
    frac = max(0.0, min(1.0, frac))
    n = int(round(frac * width))
    return "#" * n + "." * (width - n)


def _series(metrics: dict, name: str) -> List[dict]:
    return metrics.get(name, {}).get("series", [])


def _value(metrics: dict, name: str, **labels) -> float:
    total = 0.0
    for s in _series(metrics, name):
        if all(s["labels"].get(k) == v for k, v in labels.items()):
            total += s.get("value", s.get("count", 0.0))
    return total


def _fmt_ms(seconds: float) -> str:
    return f"{seconds * 1e3:8.2f}ms"


def render(snapshot: dict, *, source: str = "") -> str:
    """One dashboard frame from a registry snapshot (or the --metrics-json
    payload wrapping one under "metrics")."""
    m = snapshot.get("metrics", snapshot)
    out: List[str] = []
    title = "repro.serve dashboard"
    if source:
        title += f" — {source}"
    out.append(title)
    out.append("=" * len(title))

    # -- SLOs ---------------------------------------------------------------
    slo_states = {s["labels"]["slo"]: int(s["value"])
                  for s in _series(m, "slo_state")}
    if slo_states:
        out.append("")
        out.append("SLO burn")
        for name in sorted(slo_states):
            bf = _value(m, "slo_burn_rate", slo=name, window="fast")
            bs = _value(m, "slo_burn_rate", slo=name, window="slow")
            trans = sum(s.get("value", 0) for s in
                        _series(m, "slo_transitions_total")
                        if s["labels"].get("slo") == name)
            out.append(
                f"  {name:<12} [{_ALERT.get(slo_states[name], '?'):>4}]  "
                f"fast {_bar(bf / 2)} {bf:6.2f}  "
                f"slow {_bar(bs / 2)} {bs:6.2f}  "
                f"({trans:.0f} transitions)")

    # -- degradation controller --------------------------------------------
    if "router_controller_state" in m:
        ctl = _CTL_STATE.get(int(_value(m, "router_controller_state")), "?")
        limit = _value(m, "router_admission_limit")
        actions = {s["labels"]["action"]: int(s["value"])
                   for s in _series(m, "router_controller_total")}
        acts = " ".join(f"{k}={v}" for k, v in sorted(actions.items())) \
            or "none yet"
        out.append("")
        out.append(f"controller: {ctl:<10} admission_limit={limit:.0f}  "
                   f"actions: {acts}")

    # -- replicas -----------------------------------------------------------
    reps = sorted({s["labels"]["replica"]
                   for s in _series(m, "serve_dispatches_total")})
    if reps:
        out.append("")
        out.append("replicas")
        for rep in reps:
            st = _REPLICA_STATE.get(
                int(_value(m, "router_replica_state", replica=rep)), "-")
            pre = _value(m, "serve_dispatches_total", replica=rep,
                         phase="prefill")
            dec = _value(m, "serve_dispatches_total", replica=rep,
                         phase="decode")
            toks = _value(m, "serve_tokens_total", replica=rep,
                          phase="decode")
            out.append(f"  r{rep:<4} {st:<12} dispatches p={pre:.0f} "
                       f"d={dec:.0f}  decode_tokens={toks:.0f}")

    # -- windowed percentiles ----------------------------------------------
    winrows = []
    for fam, label in (("serve_ttft_window_seconds", "ttft"),
                       ("serve_itl_window_seconds", "itl")):
        for s in _series(m, fam):
            if not s.get("count"):
                continue
            lab = s["labels"]
            winrows.append(
                f"  {label:<5} r{lab.get('replica', '?'):<4} "
                f"{lab.get('tier', '?'):<6} "
                f"p50 {_fmt_ms(s['p50'])}  p99 {_fmt_ms(s['p99'])}  "
                f"{s['rate_per_s']:7.2f}/s  n={s['count']}"
                + ("  DROPPED" if s.get("samples_dropped") else ""))
    for s in _series(m, "router_ttft_ms_window"):
        if not s.get("count"):
            continue
        lab = s["labels"]
        winrows.append(
            f"  ttft* r{lab.get('replica', '?'):<4} "
            f"{lab.get('tier', '?'):<6} "
            f"p50 {s['p50']:8.2f}ms  p99 {s['p99']:8.2f}ms  "
            f"{s['rate_per_s']:7.2f}/s  n={s['count']}")
    if winrows:
        out.append("")
        w = next((s for s in _series(m, "serve_ttft_window_seconds")), None)
        span = f" (last {w['window_s']:.0f}s)" if w else ""
        out.append(f"windows{span}   [ttft* = router-level, incl. queueing]")
        out.extend(winrows)

    # -- router totals ------------------------------------------------------
    ev = {s["labels"]["kind"]: int(s["value"])
          for s in _series(m, "router_events_total")}
    if ev:
        keys = ("submitted", "completed", "failed", "timed_out", "retries",
                "shed_to_quantized", "rejected", "quarantines")
        line = " ".join(f"{k}={ev.get(k, 0)}" for k in keys)
        out.append("")
        out.append(f"router: {line}  queue_depth="
                   f"{_value(m, 'router_queue_depth'):.0f}")
    return "\n".join(out) + "\n"


def _fetch(url: Optional[str], path: Optional[str]) -> dict:
    if url is not None:
        with urllib.request.urlopen(url, timeout=5) as r:
            return json.loads(r.read().decode())
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--url", default=None,
                     help="metrics endpoint base (http://host:port) or a "
                          "full .../metrics.json URL")
    src.add_argument("--file", default=None,
                     help="a --metrics-json dump (rendered as one frame "
                          "unless the file keeps changing)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="seconds between repaints (default 1.0)")
    ap.add_argument("--frames", type=int, default=0, metavar="N",
                    help="exit after N frames (0 = run until interrupted)")
    ap.add_argument("--no-clear", action="store_true",
                    help="append frames instead of repainting (logs/CI)")
    args = ap.parse_args(argv)

    url = args.url
    if url is not None and not url.rstrip("/").endswith("metrics.json"):
        url = url.rstrip("/") + "/metrics.json"
    source = url or args.file

    n = 0
    try:
        while True:
            try:
                snap = _fetch(url, args.file)
            except Exception as e:                      # noqa: BLE001
                print(f"dash: cannot read {source}: {e}", file=sys.stderr)
                return 1
            frame = render(snap, source=source)
            if not args.no_clear:
                sys.stdout.write(_CLEAR)
            sys.stdout.write(frame)
            sys.stdout.flush()
            n += 1
            if args.frames and n >= args.frames:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
