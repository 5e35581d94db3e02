#!/usr/bin/env python3
"""Readings of the pair kernels K2 (FIP) and K3 (FFIP) of the PyTorch/CUDA
port on one NVIDIA card, at the shapes where they miss their targets.

    python3 tools/pair_probe.py [--out chiprun_out/pair_probe.json]

1. Launch geometry and occupancy of each K2/K3 launch, from a
   ``torch.profiler`` (CUPTI) trace: grid, block, registers a thread, shared
   memory, blocks and warps an SM, and the estimated achieved occupancy the
   trace reports, beside the device time of each launch.
2. The instruction mix of each pair-kernel instantiation, from the SASS of
   the built libraries (``cuobjdump -sass``): FFMA, FADD, IADD3, IMAD (as an
   add, IMAD.IADD; as a move, IMAD.MOV; and otherwise), LDS by width, BAR. Static counts over
   the whole kernel: which pipes the int8 body's adds take.
3. K2 and K3 back to back for about a second each while ``nvidia-smi``
   samples the SM clock and power draw: whether a clock or power cap holds
   them back, and their share of the issue-slot floor (``chip_smoke.py``'s
   count) at the clock measured.

Prints one line a reading and writes them all as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import BOOST_CLOCK_HZ, pair_counts, pair_ms  # noqa: E402

# (M, K, N): falcon-mamba-7b's in_proj at a 128-token prompt, minicpm-2b's
# up/gate projection at M 512, and the same projection at decode (M 4)
SHAPES = ((128, 4096, 16384), (512, 2304, 5760), (4, 2304, 5760))
# the keys of a kernel event's "args" in a torch.profiler chrome trace
TRACE_KEYS = ("grid", "block", "registers per thread", "shared memory",
              "blocks per SM", "warps per SM", "est. achieved occupancy %")
OPCODES = ("FFMA", "FADD", "IADD3", "IMAD.IADD", "IMAD.MOV", "IMAD",
           "LDS.128", "LDS.64", "LDS", "LDGSTS", "BAR")


def operands(m, k, n, dtype, dev, g):
    if dtype == "int8":
        return (torch.randint(-128, 128, (m, k), generator=g, device=dev)
                .to(torch.int8),
                torch.randint(-128, 128, (k, n), generator=g, device=dev)
                .to(torch.int8))
    return (torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16),
            (torch.randn((k, n), generator=g, device=dev) / k ** 0.5)
            .to(torch.bfloat16))


def calls(dev):
    """(label, shape, dtype, fn) for K2 and K3 at each shape and dtype, y and
    its carry table derived beforehand (as on the served path)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ffip_gemm import carry_for, ffip_gemm_y, y_for
    from repro_torch.kernels.fip_gemm import fip_gemm

    g = torch.Generator(device=dev).manual_seed(5)
    out = []
    for m, k, n in SHAPES:
        for dtype in ("bf16", "int8"):
            a, b = operands(m, k, n, dtype, dev, g)
            y = y_for(b)
            carry_for(y)
            fold = dtype == "int8"
            blk = dict(zip(("bm", "bn", "bk"),
                           ops.choose_blocks(m, n, k, "ffip")))
            out.append(("fip_gemm", (m, k, n), dtype, blk, fold,
                        lambda a=a, b=b, blk=blk, fold=fold:
                        fip_gemm(a, b, fold_beta=fold, **blk)))
            out.append(("ffip_gemm_y", (m, k, n), dtype, blk, fold,
                        lambda a=a, y=y, blk=blk, fold=fold:
                        ffip_gemm_y(a, y, fold_beta=fold, **blk)))
    return out


def trace_reading(cases):
    """Each case's pair-kernel launches from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    rows = []
    for label, shape, dtype, blk, _, fn in cases:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            events = json.load(open(path)).get("traceEvents", [])
        by_name = collections.defaultdict(list)
        for e in events:
            if e.get("cat") == "kernel":
                by_name[e.get("name", "")].append(e)
        for name, evs in by_name.items():
            args = evs[0].get("args", {})
            us = float(np.mean([e.get("dur", 0.0) for e in evs]))
            rows.append(dict(kernel=label, shape=shape, dtype=dtype,
                             tile=(blk["bm"], blk["bn"]), launch=name,
                             launches=len(evs), us=us,
                             **{key: args.get(key) for key in TRACE_KEYS}))
            occ = "; ".join(f"{key} {args.get(key)}" for key in TRACE_KEYS)
            print(f"  trace {label:11s} {shape} {dtype:4s} tile "
                  f"{blk['bm']}x{blk['bn']} {name[:48]}: {us:.1f} us "
                  f"(mean of {len(evs)}); {occ}", flush=True)
    return rows


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(pathlib.Path(home) / "bin" / "cuobjdump")


def sass_reading():
    """Opcode counts of each pair-kernel instantiation in the built SASS."""
    from repro_torch.kernels import compat

    rows = []
    for source in ("fip_gemm", "ffip_gemm"):
        lib = compat._lib_path(compat.CSRC / f"{source}.cu")
        text = subprocess.run([cuobjdump(), "-sass", str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        name, counts = None, None
        for line in text.splitlines() + ["Function : <end>"]:
            head = re.search(r"Function : (\S+)", line)
            if head:
                if name and "pair_kernel" in name:
                    rows.append(dict(source=source, kernel=name, **counts))
                name, counts = head.group(1), collections.Counter()
                continue
            op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                           r"([A-Z][A-Z0-9_.]*)", line)
            if op and counts is not None:
                full = op.group(1)
                for key in OPCODES:
                    if full == key or full.startswith(key + "."):
                        counts[key] += 1
                        break
                counts["all"] += 1
    try:
        shown = subprocess.run(["c++filt"],
                               input="\n".join(r["kernel"] for r in rows),
                               capture_output=True, text=True,
                               timeout=60).stdout.split("\n")
        for r, s in zip(rows, shown):
            r["kernel"] = s or r["kernel"]
    except (OSError, subprocess.SubprocessError):
        pass
    for r in rows:
        mix = ", ".join(f"{k} {r.get(k, 0)}" for k in OPCODES + ("all",))
        print(f"  sass {r['kernel'][:90]}: {mix}", flush=True)
    return rows


def load_reading(cases):
    """Back to back for about a second, clock and power sampled meanwhile."""
    rows = []
    for label, (m, k, n), dtype, blk, fold, fn in cases:
        if m < 128:
            continue
        fn()
        torch.cuda.synchronize()
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        try:
            n_calls, t0 = 0, time.perf_counter()
            while time.perf_counter() - t0 < 1.0:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
                n_calls += 10
            ms = (time.perf_counter() - t0) / n_calls * 1e3
        finally:
            smi.terminate()
            lines = smi.communicate(timeout=30)[0].split("\n")
        vals = [tuple(float(v) for v in r.split(",")) for r in lines
                if r.count(",") == 1][1:]
        mhz = float(np.median([v[0] for v in vals])) if vals else 0.0
        watts = float(np.median([v[1] for v in vals])) if vals else 0.0
        floor = pair_ms(*pair_counts(m, n, k, fold), integer=fold)
        share = (floor * BOOST_CLOCK_HZ / (mhz * 1e6) / ms if mhz
                 else float("nan"))
        rows.append(dict(kernel=label, shape=(m, k, n), dtype=dtype,
                         tile=(blk["bm"], blk["bn"]), ms=ms, sm_mhz=mhz,
                         watts=watts, samples=len(vals), floor_share=share))
        print(f"  load {label:11s} M={m} K={k} N={n} {dtype:4s} tile "
              f"{blk['bm']}x{blk['bn']}: {ms:.4f} ms a call back to back; "
              f"SM clock {mhz:.0f} MHz, power {watts:.1f} W (median of "
              f"{len(vals)} samples); {share:.3f} of the issue-slot floor "
              f"at that clock", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "pair_probe.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import compat

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    compat.build_all(["fip_gemm", "ffip_gemm"])
    dev = torch.device("cuda", 0)
    cases = calls(dev)
    result = dict(card=card, trace=trace_reading(cases),
                  sass=sass_reading(), load=load_reading(cases))
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1, default=str))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
