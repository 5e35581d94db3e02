#!/usr/bin/env python3
"""Where int8 serving on the card first leaves the host's (ROADMAP queue 3,
F6). Serves one smoke model in bf16, int8 FFIP, ``gemm_impl="cuda"``, with
the same weights (drawn on the host from seed 0, then copied to the card)
and the same prompts on the host (every kernel wrapper on its plain
version) and on the card, and records in call order:

* every dense layer's input x, its int8 activations and per-token scale and
  zero point (``core.quant.quantize_activations``) and its output, with the
  dispatch (a prefill or a decode call of the model) and the weight's path
  and layer;
* every Mamba2 SSD call's output and final state (``models.ssm._ssd_chunked``,
  its f32 einsums) and every flash-attention call's output (K4 on the card,
  its plain version on the host).

It then names the first record whose bits differ between the two runs, and
the first dense call whose int8 codes differ: how many codes, by how much,
and for each differing code how far the host's x / scale lay from a
rounding boundary, in units of one bf16 ulp of x (a ratio at or below 1
means one bf16 rounding of x on either side could flip it). Each model is
run twice: with flash attention (K4) and with plain attention on both sides
(``attention_impl="naive"``), which takes K4 out of the comparison.

    python3 tools/int8_probe.py [--arch zamba2-1.2b minicpm-2b] \\
        [--out chiprun_out/int8_probe.json]

Needs one card. Prints one line a reading and writes them as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402


class Trace:
    """One run's records, in call order."""

    def __init__(self):
        self.records = []
        self.dispatch = -1

    def add(self, kind, **fields):
        self.records.append(dict(kind=kind, dispatch=self.dispatch,
                                 **{k: (v.detach().cpu()
                                        if isinstance(v, torch.Tensor) else v)
                                    for k, v in fields.items()}))


@contextlib.contextmanager
def recording(trace: Trace):
    """Wrap the recorded functions at their call sites for one run."""
    from repro_torch.core import quant
    from repro_torch.models import attention, ssm
    from repro_torch.models.model import Model

    saved = []

    def patch(obj, name, wrapper):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, wrapper(getattr(obj, name)))

    def dispatch(fn):
        def run(*a, **kw):
            trace.dispatch += 1
            return fn(*a, **kw)
        return run

    def activations(fn):
        def run(x):
            aq, scale, zp = fn(x)
            trace.add("dense_in", x=x, aq=aq, scale=scale, zp=zp)
            return aq, scale, zp
        return run

    def dense(fn):
        def run(x, q, **kw):
            out = fn(x, q, **kw)
            trace.records[-1]["ptr"] = q["qw"].data_ptr()
            trace.add("dense_out", out=out, ptr=q["qw"].data_ptr())
            return out
        return run

    def ssd(fn):
        def run(*a, **kw):
            y, state = fn(*a, **kw)
            trace.add("ssd", y=y, state=state)
            return y, state
        return run

    def flash(fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            trace.add("flash", out=out)
            return out
        return run

    for name in ("prefill", "prefill_sample", "sample_steps"):
        patch(Model, name, dispatch)
    patch(quant, "quantize_activations", activations)
    patch(quant, "quantized_dense_apply", dense)
    patch(ssm, "_ssd_chunked", ssd)
    patch(attention, "flash_attention", flash)
    try:
        yield
    finally:
        for obj, name, fn in reversed(saved):
            setattr(obj, name, fn)


def weight_paths(params):
    """(path, base pointer, bytes a layer, layers) of every int8 weight."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            if "qw" in node:
                qw = node["qw"]
                per = qw[0].numel() if qw.dim() == 3 else qw.numel()
                out.append(("/".join(path), qw.data_ptr(), per,
                            qw.shape[0] if qw.dim() == 3 else 1))
            for k, v in node.items():
                walk(v, path + [k])

    walk(params, [])
    return out


def name_of(ptr, paths) -> str:
    for path, base, per, n in paths:
        if base <= ptr < base + per * n:
            return f"{path}[{(ptr - base) // per}]"
    return "?"


def serve_recorded(model, params, prompts, kw):
    from repro_torch.launch.serve import serve
    trace = Trace()
    with recording(trace):
        srv, done, _ = serve(model, params, prompts, **kw)
    paths = weight_paths(srv._prepared_params)
    for r in trace.records:
        if "ptr" in r:
            r["layer"] = name_of(r.pop("ptr"), paths)
    return trace, {r.rid: list(r.out_tokens) for r in done}


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to(torch.int32)
    if t.dtype == torch.float32:
        return t.view(torch.int32).to(torch.int64)
    return t.to(torch.int64)


def first_difference(host, card):
    """The first record whose tensors differ, and the first dense call whose
    int8 codes differ."""
    first = codes = None
    for i, (h, c) in enumerate(zip(host.records, card.records)):
        if h["kind"] != c["kind"]:
            return dict(index=i, kind="schedule", host=h["kind"],
                        card=c["kind"]), codes
        for key, hv in h.items():
            if not isinstance(hv, torch.Tensor):
                continue
            cv = c[key]
            if hv.shape != cv.shape:
                return dict(index=i, kind="shape", field=key), codes
            diff = _bits(hv) != _bits(cv)
            if bool(diff.any()) and first is None:
                d = (hv.double() - cv.double()).abs()
                first = dict(index=i, kind=h["kind"], field=key,
                             dispatch=h["dispatch"],
                             layer=h.get("layer", ""),
                             elements=int(diff.sum()), of=hv.numel(),
                             max_abs=float(d.max()),
                             max_rel=float((d / hv.double().abs().clamp_min(
                                 1e-30)).max()))
                if hv.dtype == torch.bfloat16:
                    first["max_ulps"] = int((_bits(hv) - _bits(cv)).abs()
                                            .max())
        if h["kind"] == "dense_in" and codes is None and not torch.equal(
                h["aq"], c["aq"]):
            codes = code_reading(h, c, i)
        if first is not None and codes is not None:
            break
    return first, codes


def code_reading(h, c, i):
    """How the int8 codes of one dense call differ, and how close the host's
    values lay to a rounding boundary against one bf16 ulp of x."""
    dq = h["aq"].to(torch.int32) - c["aq"].to(torch.int32)
    where = dq != 0
    xs = h["x"].float() / h["scale"]           # (rows, K) in code units
    dist = (xs - torch.floor(xs) - 0.5).abs()  # to the boundary at .5
    ulp = _bf16_ulp(h["x"]) / h["scale"]
    ratio = (dist / ulp)[where]
    rows = where.any(dim=-1)
    return dict(index=i, dispatch=h["dispatch"], layer=h.get("layer", ""),
                codes=int(where.sum()), of=int(where.numel()),
                max_code_diff=int(dq.abs().max()),
                rows=int(rows.sum()),
                x_bits_equal=bool(torch.equal(_bits(h["x"]), _bits(c["x"]))),
                scale_equal_rows=int((h["scale"] == c["scale"])
                                     .squeeze(-1)[rows].sum()),
                boundary_over_ulp_max=float(ratio.max()),
                boundary_over_ulp_median=float(ratio.median()))


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    a = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def probe(arch: str, attention: str, dev):
    from repro_torch import configs
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(
        configs.smoke_config(configs.get_config(arch)),
        param_dtype="bfloat16", attention_impl=attention)
    prompts = make_prompts(cfg.vocab, 6, np.random.default_rng(5), 3, 16)
    kw = dict(max_new=6, batch_slots=2, max_len=32, gemm_algo="ffip",
              gemm_impl="cuda", quantized=True, decode_chunk=4)
    host = Model(cfg, device="cpu")
    params = host.init(0)
    h_trace, h_tok = serve_recorded(host, params, prompts, kw)
    card_params = _to(params, dev)
    c_trace, c_tok = serve_recorded(Model(cfg, device=dev), card_params,
                                    prompts, kw)
    first, codes = first_difference(h_trace, c_trace)
    steps = [next((i for i, (a, b) in enumerate(zip(h_tok[r], c_tok[r]))
                   if a != b), None) for r in sorted(h_tok)]
    out = dict(arch=arch, attention=attention, records=len(h_trace.records),
               dispatches=h_trace.dispatch + 1, tokens_equal=h_tok == c_tok,
               first_token_difference=steps, first_difference=first,
               first_code_difference=codes)
    print(json.dumps(out), flush=True)
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="+", default=["zamba2-1.2b",
                                                  "minicpm-2b"])
    ap.add_argument("--out", default="chiprun_out/int8_probe.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import compat
    compat.build_all()
    dev = torch.device("cuda", 0)
    rows = [probe(arch, attn, dev) for arch in args.arch
            for attn in ("flash", "naive")]
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
