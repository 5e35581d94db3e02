"""Roofline terms of a traced step, counterpart of
``repro/launch/roofline.py``.

The compute and memory terms divide the FLOPs and bytes of
:mod:`repro_torch.launch.costs` by the card's peaks; the collective term
divides the wire bytes of the collectives one rank issues. Bytes on the wire
a collective kind (ring algorithms, group size N), as the reference models
them:

    all-gather:          out_bytes * (N-1)/N        (out is the gathered buf)
    reduce-scatter:      out_bytes * (N-1)          (operand = out * N)
    all-reduce:          2 * bytes * (N-1)/N        (RS + AG phases)
    all-to-all:          bytes * (N-1)/N
    collective-permute:  bytes

The reference parses its collectives out of XLA's optimised HLO text
(``collective_bytes``, ``_trip_count``, ``remat_duplication``). The port has
no HLO: its collectives are the ones ``repro_torch.dist.context`` issues,
which a costing trace records call by call (``context.record_collectives``)
and :func:`collective_stats` turns into :class:`CollectiveStats`. A Python
loop over layers records each layer's calls, so no trip count is needed,
and the parser has no counterpart.

The default peaks are the H100 SXM's published dense rates (NVIDIA's data
sheet): 989 TFLOP/s bf16 and 1979 TOP/s int8 on the tensor cores, 66.9
TFLOP/s f32 on the CUDA cores (2 x 128 FMA lanes x 132 SMs x 1.98 GHz), 3.35
TB/s of HBM and 450 GB/s of NVLink each way. The cell's compute dtype
chooses the FLOP peak, and the report names it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.launch.costs import HBM_BYTES_S, PEAK_OPS_S

NVLINK_BYTES_S = 450e9
PEAK_FLOPS = {"bf16": PEAK_OPS_S["bf16"], "float16": PEAK_OPS_S["bf16"],
              "int8": PEAK_OPS_S["int8"], "f32": PEAK_OPS_S["cuda_core"]}
PEAK_UNITS = {"bf16": "bf16 tensor cores", "float16": "fp16 tensor cores",
              "int8": "int8 tensor cores",
              "f32": "f32 CUDA cores (no TF32)"}
_DTYPE_KEYS = {"bfloat16": "bf16", "bf16": "bf16", "float16": "float16",
               "int8": "int8", "float32": "f32", "f32": "f32"}


def peak_key(dtype) -> str:
    """The :data:`PEAK_FLOPS` key of a compute dtype (a torch dtype or its
    name)."""
    name = str(dtype).replace("torch.", "")
    if name not in _DTYPE_KEYS:
        raise ValueError(f"no H100 peak for compute dtype {dtype!r}")
    return _DTYPE_KEYS[name]


def wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Bytes on the wire of one collective of ``kind`` over ``nbytes`` in a
    group of ``n`` ranks (the module docstring's ring model)."""
    if kind == "all-gather":
        return nbytes * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return nbytes * (n - 1)
    if kind == "all-reduce":
        return 2 * nbytes * (n - 1) / max(n, 1)
    if kind == "all-to-all":
        return nbytes * (n - 1) / max(n, 1)
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, float]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


def collective_stats(records: Iterable[Tuple[str, float, int]]
                     ) -> CollectiveStats:
    """:class:`CollectiveStats` of recorded ``(kind, bytes, group size)``
    collectives: their count and wire bytes a kind."""
    counts: Dict[str, int] = {}
    by_kind: Dict[str, float] = {}
    for kind, nbytes, n in records:
        counts[kind] = counts.get(kind, 0) + 1
        by_kind[kind] = by_kind.get(kind, 0.0) + wire_bytes(kind, nbytes, n)
    return CollectiveStats(counts=counts, bytes_by_kind=by_kind)


def roofline_report(flops: float, hlo_bytes: float,
                    coll: Optional[CollectiveStats], chips: int, *,
                    dtype="bf16", peak_flops: Optional[float] = None,
                    hbm_bw: float = HBM_BYTES_S,
                    ici_bw: float = NVLINK_BYTES_S,
                    model_flops: Optional[float] = None,
                    collective_reason: str = "") -> dict:
    """The reference's report: the three terms, the bottleneck, the step
    time's lower bound and the roofline fraction (its keys and formulas),
    plus ``peak`` naming the rates used. ``peak_flops`` defaults to the
    peak of ``dtype``'s unit. ``coll=None`` (the port's mesh path does not
    take the cell) gives ``collective_s: None`` with ``collective_reason``,
    and the bottleneck covers the terms that exist."""
    key = peak_key(dtype)
    if peak_flops is None:
        peak_flops = PEAK_FLOPS[key]
    compute_s = flops / (chips * peak_flops)
    memory_s = hlo_bytes / (chips * hbm_bw)
    collective_s = (None if coll is None
                    else coll.total_bytes / (chips * ici_bw))
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    present = {k: v for k, v in terms.items() if v is not None}
    dominant = max(present, key=present.get)
    bound = max(present.values())
    out = dict(terms)
    out.update(
        bottleneck=dominant,
        step_time_lower_bound_s=bound,
        # fraction of the step-time bound that is useful compute: 1.0 means
        # perfectly compute-bound (the roofline optimum for the algorithm)
        roofline_fraction=(compute_s / bound) if bound else 0.0,
        collective_counts={} if coll is None else coll.counts,
        collective_bytes=None if coll is None else coll.total_bytes,
    )
    if coll is None:
        out["collective_reason"] = collective_reason
    if model_flops:
        out["model_flops"] = model_flops
        out["useful_flops_ratio"] = model_flops / flops if flops else 0.0
    out["peak"] = {"unit": PEAK_UNITS.get(key, key), "flops_s": peak_flops,
                   "hbm_bytes_s": hbm_bw, "link_bytes_s": ici_bw}
    return out
