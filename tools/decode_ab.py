#!/usr/bin/env python3
"""Decode ms/step of the served minicpm-2b run at two trees of the port on
one NVIDIA card: the same run as ``chip_smoke.py``'s main phase (40 layers
at published widths, random weights from seed 0, 4 slots, 8 prompts of
16-128 tokens, 16 new tokens each), through ``python -m
repro_torch.launch.serve`` in a fresh process a run.

    python3 tools/decode_ab.py --base DIR [--order BCHHCB] \
        [--out chiprun_out/decode_ab.json]

``--base`` is another checkout of the repo (say the parent commit, from
``git archive``); this script's own tree is the change. Each letter of
``--order`` is one run of each variant (ffip, int8 ffip): ``B`` the base
tree, ``C`` this tree, ``H`` this tree with ``--metrics-json`` (the kernel
hooks of ``repro_torch.obs.profile`` on). Alternate the trees, since a
host-bound step drifts between runs. Prints one line a run, the card's
name and power limit, and the mean of each (tree, variant), and writes
them as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
RUN = ["--arch", "minicpm-2b", "--layers", "40", "--slots", "4",
       "--requests", "8", "--prompt-len", "16,129", "--max-len", "256",
       "--max-new", "16", "--gemm-impl", "cuda", "--gemm-algo", "ffip",
       "--seed", "0"]
VARIANTS = {"ffip": [], "int8-ffip": ["--quantized"]}
DECODE = re.compile(r"prefill ([0-9.]+)s .*decode ([0-9.]+)s over (\d+) "
                    r"steps")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run(tree: pathlib.Path, extra: list) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *RUN, *extra], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0 or not out.stdout.rstrip().endswith("OK"):
        raise SystemExit(f"FAIL: {tree} {extra}: rc {out.returncode}\n"
                         f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    m = DECODE.search(out.stdout)
    prefill, decode, steps = float(m[1]), float(m[2]), int(m[3])
    return dict(prefill_s=prefill, decode_ms_step=1e3 * decode / steps,
                steps=steps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, type=pathlib.Path)
    ap.add_argument("--order", default="BCHHCB")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "decode_ab.json"))
    args = ap.parse_args(argv)
    trees = {"B": args.base.resolve(), "C": ROOT, "H": ROOT}
    gpu = card()
    print(f"card: {gpu}", flush=True)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, tag in enumerate(args.order):
            for name, flags in VARIANTS.items():
                extra = list(flags)
                if tag == "H":
                    extra += ["--metrics-json", f"{tmp}/m{i}.json"]
                r = dict(run(trees[tag], extra), tree=tag, variant=name,
                         index=i)
                rows.append(r)
                print(f"run {i} {tag} {name}: decode "
                      f"{r['decode_ms_step']:.3f} ms/step over {r['steps']} "
                      f"steps, prefill {r['prefill_s']:.3f} s", flush=True)
    means = {}
    for tag in sorted(set(args.order)):
        for name in VARIANTS:
            ms = [r["decode_ms_step"] for r in rows
                  if r["tree"] == tag and r["variant"] == name]
            means[f"{tag} {name}"] = sum(ms) / len(ms)
            print(f"mean {tag} {name}: {means[f'{tag} {name}']:.3f} ms/step "
                  f"over {len(ms)} runs ({gpu})", flush=True)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=gpu, runs=rows, means=means), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
