"""Markdown tables of the dry-run results, counterpart of
``repro/launch/report.py``.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir DIR]

prints the §Dry-run and §Roofline tables of ``build/reports/dryrun/``
(written by ``python -m repro_torch.launch.dryrun``) to stdout, and a
§Memory table of the port's own byte counts. Nothing needs a card: the
results come from meta-device traces.
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Optional

from repro_torch.launch.dryrun import RESULTS_DIR
from repro_torch.launch.roofline import HBM_BYTES_S, NVLINK_BYTES_S, PEAK_FLOPS

RESULTS = RESULTS_DIR


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}EB"


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 0.1:
        return f"{x:.3f}s"
    if x >= 1e-4:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def load(results: Optional[pathlib.Path], mesh: str):
    """The result files of ``mesh`` in ``results`` (default
    :data:`RESULTS`), sorted by name."""
    results = pathlib.Path(results or RESULTS)
    return [json.loads(f.read_text())
            for f in sorted(results.glob(f"*__{mesh}.json"))]


def dryrun_section(results: Optional[pathlib.Path] = None) -> str:
    out = ["## §Dry-run", "",
           "Every (arch x shape) cell traced at full width on the meta "
           "device, for the single-pod 16x16 mesh (256 cards) and the "
           "multi-pod 2x16x16 mesh (512). `compile` is the trace's seconds; "
           "`bytes/dev` is not measured (no compiler plans the port's "
           "buffers; see §Memory); the collective mix is one rank's, "
           "recorded through the port's own mesh path.", ""]
    for mesh in ("16x16", "2x16x16"):
        rows = load(results, mesh)
        ok = sum(1 for r in rows if r.get("status") == "ok")
        skip = sum(1 for r in rows if r.get("status") == "skipped")
        fail = [r for r in rows if r.get("status") == "failed"]
        out.append(f"### mesh {mesh}: {ok} compiled, {skip} skipped, "
                   f"{len(fail)} failed")
        out.append("")
        out.append("| arch | shape | status | compile | bytes/dev | "
                   "collectives (count) | wire bytes |")
        out.append("|---|---|---|---|---|---|---|")
        for r in rows:
            if r.get("status") == "ok":
                colls = ", ".join(f"{k}:{v}" for k, v in
                                  sorted(r.get("collective_counts",
                                               {}).items()))
                out.append(
                    f"| {r['arch']} | {r['shape']} | ok | {r['compile_s']}s "
                    f"| {fmt_bytes(r.get('bytes_per_device'))} | "
                    f"{colls or '-'} | "
                    f"{fmt_bytes(r.get('collective_bytes'))} |")
            elif r.get("status") == "skipped":
                out.append(f"| {r['arch']} | {r['shape']} | skipped | - | - "
                           f"| {r.get('reason', '')[:60]} | - |")
            else:
                out.append(f"| {r['arch']} | {r['shape']} | FAILED | - | - "
                           f"| {r.get('error', '')[:60]} | - |")
        out.append("")
    return "\n".join(out)


def _collective_cell(r) -> str:
    if r.get("collective_s") is None and r.get("collective_reason"):
        return f"- ({r['collective_reason'][:60]})"
    return fmt_s(r.get("collective_s"))


def roofline_section(results: Optional[pathlib.Path] = None) -> str:
    out = ["## §Roofline", "",
           "Single-pod (16x16, 256 H100 cards) terms: compute = "
           f"FLOPs/(cards x {PEAK_FLOPS['bf16'] / 1e12:.0f} TF/s bf16 on the "
           f"tensor cores; {PEAK_FLOPS['f32'] / 1e12:.1f} for an f32 cell on "
           f"the CUDA cores), memory = bytes/(cards x "
           f"{HBM_BYTES_S / 1e12:.2f} TB/s of HBM), collective = "
           f"wire-bytes/(cards x {NVLINK_BYTES_S / 1e9:.0f} GB/s of NVLink "
           "each way). The peaks are the data sheet's dense rates at the "
           "card's full 700 W power limit; a card set below it "
           "(`nvidia-smi --query-gpu=power.limit`) runs slower. FLOPs and "
           "bytes are global counts of the meta-device trace "
           "(launch/costs.py: the aten ops and each kernel's own charge). "
           "`useful` = MODEL_FLOPS / FLOPs where MODEL_FLOPS = 6*N_active*D "
           "(train) or 2*N_active*D (inference). A `-` collective term is "
           "a cell the port's mesh path does not take, with its reason.",
           "",
           "| arch | shape | compute | memory | collective | bottleneck | "
           "roofline frac | useful flops |",
           "|---|---|---|---|---|---|---|---|"]
    worst = []
    for r in load(results, "16x16"):
        if r.get("status") != "ok":
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {_collective_cell(r)} | "
            f"{r['bottleneck'].replace('_s', '')} | "
            f"{r['roofline_fraction']:.3f} | "
            f"{r.get('useful_flops_ratio', 0):.2f} |")
        worst.append((r["roofline_fraction"], r["arch"], r["shape"],
                      r["bottleneck"]))
    out.append("")
    worst.sort()
    out.append("Lowest roofline fractions (hillclimb candidates): " +
               "; ".join(f"{a} x {s} ({f:.3f}, {b.replace('_s','')}-bound)"
                         for f, a, s, b in worst[:6]))
    out.append("")
    return "\n".join(out)


def memory_section(results: Optional[pathlib.Path] = None) -> str:
    """The port's byte counts: one device's argument pieces under the
    production mesh's rule table, and the single-device trace's peak of
    live tensor storage."""
    out = ["## §Memory", "",
           "`args/dev`: one device's pieces of the params (and the AdamW "
           "state), the cache and the batch under the 16x16 rule table. "
           "`peak live`: the largest live tensor storage of the global, "
           "single-device trace (no rematerialisation).", "",
           "| arch | shape | args/dev | peak live (global) |", "|---|---|---|---|"]
    for r in load(results, "16x16"):
        if r.get("status") == "ok":
            out.append(f"| {r['arch']} | {r['shape']} | "
                       f"{fmt_bytes(r.get('argument_bytes'))} | "
                       f"{fmt_bytes(r.get('peak_live_bytes'))} |")
    out.append("")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=None,
                    help=f"results directory (default {RESULTS})")
    args = ap.parse_args(argv)
    print(dryrun_section(args.dir))
    print(roofline_section(args.dir))
    print(memory_section(args.dir))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
