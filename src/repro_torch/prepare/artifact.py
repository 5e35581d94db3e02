"""``PreparedModel``: the serializable offline-prep artifact, counterpart of
``repro/prepare/artifact.py``.

Everything expensive about deploying an FFIP model is offline work (§4.4):
per-channel int8 weights with beta folded into the integer bias (Eq. 15)
and the colsums, the Eq. 9 y deltas, BN folding for the vision stacks, and
the ``repro_torch.tune`` schedules. ``PreparedModel`` holds all of them and
serializes to one directory (an atomic tmp-dir + rename).

The format is the reference's: ``manifest.json`` (version, kind, device
kind, schedule slice, meta, the tree's structure) beside one
``arr_NNNNN.npy`` a leaf, so a JAX-written f32 artifact loads here and a
port-written f32 one loads there. A bf16 leaf is written as its uint16
bit pattern with ``"dt": "bfloat16"`` on its ``arr`` node (the reference
reads only ``"i"``); a leaf that ``np.save`` wrote as a 2-byte void
(``<V2``: the reference's bf16 leaves) or that carries the tag loads as
bf16, bit for bit.

Warm-start contract: after :func:`load`, serving from the artifact does no
quantization (``core.quant.counters``), no y derivation and no carry table
(``kernels.compat.computed_by_tag``) and no tuning measurement
(``tune.measure.counters``); ``recomputed`` sums their deltas since the
load. K3's carry tables are no part of a JAX artifact: :func:`load` builds
them for the loaded y on the card, inside the load, and reports them in
``built``, as it reports a tied unembed's y that an artifact lacks (the
reference never memoizes that one: it derives it inside its jit).

Which y deltas an artifact carries: those the port's server hands the FFIP
kernel for its tier (``serve.batcher``'s warm-up): the int8 codes' (int32)
for a quantized artifact, the float weights' otherwise, and the tied
unembed's (``"embed/table.T"``) in both. The reference's quantized
artifact carries the float weights' y, which the port's int8 server never
reads.

Portability: the schedule slice is keyed by device kind and rides only on
matching hardware; under another kind it is dropped with a one-time
warning (the weights and y deltas still load). A corrupt artifact is
quarantined to ``<dir>.corrupt``.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import shutil
import time
import warnings
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import tune
from repro_torch.core import fip, quant
from repro_torch.kernels import compat
from repro_torch.kernels.ffip_gemm import CARRY_TAG, Y_TAG, carry_table
from repro_torch.tune import measure

log = logging.getLogger("repro_torch.prepare")

_VERSION = 1
_MANIFEST = "manifest.json"
# The derived key of a tied unembed's y: its forward reads ``table.T``.
TIED_UNEMBED = "embed/table.T"

# one-time-warning memory for schedule-slice drops (artifact, device) pairs
_warned_drops: set = set()


class ArtifactError(RuntimeError):
    """A prepared artifact is missing or corrupt (corrupt => quarantined)."""


def counters_snapshot() -> Dict[str, int]:
    """The offline-work counters: quantizations, y derivations, carry
    tables, tuning measurements. ``PreparedModel.recomputed`` is the delta
    since construction or load."""
    return {
        "quantize": quant.counters["prepare_dense"],
        "y_encode": compat.computed_by_tag.get(Y_TAG, 0),
        "carry": compat.computed_by_tag.get(CARRY_TAG, 0),
        "tune": measure.counters["timed_candidates"],
    }


# ---------------------------------------------------------------------------
# Structure codec: dicts / lists / tuples of tensors and Python scalars (a
# conv q entry's k_real / kh / kw / groups stay Python ints). Tensors go to
# .npy files, the structure into the manifest.
# ---------------------------------------------------------------------------

def _encode(obj: Any, leaves: list) -> dict:
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, dict):
        keys = list(obj.keys())
        if not all(isinstance(k, str) for k in keys):
            raise TypeError(f"artifact dicts need str keys, got {keys!r}")
        return {"t": "dict", "k": keys,
                "v": [_encode(obj[k], leaves) for k in keys]}
    if isinstance(obj, (list, tuple)):
        return {"t": "list" if isinstance(obj, list) else "tuple",
                "v": [_encode(x, leaves) for x in obj]}
    if isinstance(obj, (bool, int, float, str)):
        return {"t": "py", "v": obj}
    t = torch.as_tensor(obj).detach()
    leaves.append(t)
    node = {"t": "arr", "i": len(leaves) - 1}
    if t.dtype == torch.bfloat16:
        node["dt"] = "bfloat16"
    return node


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _leaf(arr: np.ndarray, bf16: bool, device: torch.device) -> torch.Tensor:
    """A loaded leaf on ``device``: a 2-byte void or tagged leaf viewed as
    bf16 through its bits (``bridge``'s idiom). A memory-mapped file goes
    straight to the card; on the CPU the tensor is the one copy."""
    bits = bf16 or arr.dtype.kind == "V"
    if bits:
        arr = arr.view(np.int16)
    with warnings.catch_warnings():
        # a read-only memory map: the tensor is copied before any write
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    t = t.to(device, copy=True)
    return t.view(torch.bfloat16) if bits else t


def _decode(node: dict, leaves: list, device) -> Any:
    t = node["t"]
    if t == "none":
        return None
    if t == "dict":
        return {k: _decode(v, leaves, device)
                for k, v in zip(node["k"], node["v"])}
    if t in ("list", "tuple"):
        seq = [_decode(v, leaves, device) for v in node["v"]]
        return seq if t == "list" else tuple(seq)
    if t == "py":
        return node["v"]
    if t == "arr":
        arr = leaves[node["i"]]
        return _leaf(arr, node.get("dt") == "bfloat16", device)
    raise ValueError(f"unknown artifact node type {t!r}")


def _leaf_at(tree: Any, path: str) -> Optional[Any]:
    node = tree
    for seg in path.split("/"):
        if isinstance(node, dict):
            if seg not in node:
                if seg == "table.T" and "table" in node:
                    return node["table"].T
                return None
            node = node[seg]
        elif isinstance(node, (list, tuple)):
            try:
                node = node[int(seg)]
            except (ValueError, IndexError):
                return None
        else:
            return None
    return node


def _spec_at(specs: Any, path: str):
    """The spec of the leaf at ``path`` in a spec tree; ``"table.T"`` is
    the table's spec transposed."""
    node = specs
    for seg in path.split("/"):
        if isinstance(node, dict) and seg in node:
            node = node[seg]
        elif isinstance(node, dict) and seg == "table.T" and "table" in node:
            t = node["table"]
            return type(t)(*reversed(t))
        else:
            return None
    return node


def _ffip_operands(node: Any, quantized: bool, path: Tuple[str, ...] = ()
                   ) -> Iterator[Tuple[str, torch.Tensor]]:
    """("a/b/w", w) for every dense weight the server hands the FFIP
    kernel: even-K ``w`` leaves, or their int8 ``q/qw`` when ``quantized``
    and the layer has one (``serve.batcher._ffip_weights``' choice)."""
    if isinstance(node, dict):
        w = node.get("w")
        if isinstance(w, torch.Tensor) and w.dim() >= 2:
            if w.shape[-2] % 2 == 0:
                if quantized and isinstance(node.get("q"), dict):
                    yield "/".join(path + ("q", "qw")), node["q"]["qw"]
                else:
                    yield "/".join(path + ("w",)), w
            return
        for k, v in node.items():
            yield from _ffip_operands(v, quantized, path + (str(k),))


def _views(t: torch.Tensor):
    """The (K, N) matrices of a stacked weight, as the forward slices it:
    views of one storage, whatever the leading dims."""
    if t.dim() == 2:
        return [t]
    return list(t.reshape(-1, *t.shape[-2:]))


def _make_y_nd(w: torch.Tensor) -> torch.Tensor:
    """Eq. 9 of each (K, N) matrix of a stacked weight (leading dims are
    layers and groups)."""
    if w.dim() == 2:
        return fip.make_y(w)
    return torch.stack([fip.make_y(v) for v in _views(w)]).reshape(
        *w.shape[:-2], *w.shape[-2:])


def _tied(params) -> bool:
    return (isinstance(params, dict) and "unembed" not in params
            and isinstance(params.get("embed"), dict)
            and "table" in params["embed"])


# ---------------------------------------------------------------------------
# The artifact
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PreparedModel:
    """Run-ready offline-prepared model: params with int8 ``q`` entries
    attached, the y deltas, on the card their carry tables, and the
    device-keyed schedule slice.

    ``derived`` maps ``"path/to/w"`` (``"path/q/qw"``, ``TIED_UNEMBED``) to
    its Eq. 9 y deltas, ``carry`` the same paths to their K3 carry tables
    (built on the card, never saved). :meth:`seed_into` installs both into
    a per-weight memo, a layer's view of a stacked weight by itself, so the
    kernels find them instead of deriving them.
    """
    kind: str                               # "lm" | "vision"
    device: str                             # device kind at prepare time
    quantized: bool
    params: Any
    derived: Dict[str, Any] = dataclasses.field(default_factory=dict)
    schedule: Dict[str, dict] = dataclasses.field(default_factory=dict)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    carry: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # what load derived that the artifact lacked: carry tables, y
    built: Dict[str, int] = dataclasses.field(default_factory=dict)
    # the offline-work counters at construction or load; every
    # PreparedModel of a process shares the counters, so the delta is the
    # offline work done anywhere since this artifact became ready
    baseline: Dict[str, int] = dataclasses.field(
        default_factory=counters_snapshot)
    # this artifact's cuts by (mesh, specs): the servers that share the
    # artifact on a rank share its cut (a router's replicas of one tier)
    cuts: Dict[Any, "PreparedModel"] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def recomputed(self) -> int:
        """Offline transforms recomputed since this artifact was prepared
        or loaded. The warm-start contract is ``recomputed == 0``."""
        return sum(self.recompute_report().values())

    def recompute_report(self) -> Dict[str, int]:
        now = counters_snapshot()
        return {k: now[k] - self.baseline[k] for k in now}

    def seed_into(self, memo: compat.DerivedCache) -> int:
        """Seed ``memo`` with every y delta (under ``Y_TAG``, keyed by its
        weight's view) and carry table (under ``CARRY_TAG``, keyed by the
        y view). Returns the entries seeded."""
        n = 0
        for path, y in self.derived.items():
            w = _leaf_at(self.params, path)
            if not isinstance(w, torch.Tensor) or w.shape != y.shape:
                continue
            carry = self.carry.get(path)
            for i, (wv, yv) in enumerate(zip(_views(w), _views(y))):
                memo.seed(Y_TAG, wv, yv)
                n += 1
                if carry is not None:
                    memo.seed(CARRY_TAG, yv, carry[i])
                    n += 1
        return n

    def build_carry(self) -> int:
        """K3's carry table of each (K, N) y on the card (none on the CPU,
        where the plain version rebuilds the weights itself)."""
        n = 0
        for path, y in self.derived.items():
            if (path not in self.carry and isinstance(y, torch.Tensor)
                    and y.device.type == "cuda"):
                self.carry[path] = [carry_table(v) for v in _views(y)]
                n += len(self.carry[path])
        return n

    def shard(self, specs, mesh) -> "PreparedModel":
        """This rank's cut of the artifact for tensor parallelism: its
        pieces of the params under ``specs`` (``dist.sharding``), and of
        each y delta under its weight's spec. Eq. 9's y runs along N, so a
        column piece of the whole y starts with the delta from the column
        before the cut: its first column is set to the weight's own (the
        int8 codes' or the float weight's), which makes it the piece's own
        y; a :class:`~repro_torch.dist.sharding.Blocked` piece (Mamba1's
        ``in_proj``, x | z) also sets the first column of each later block
        to the piece's own delta there, Eq. 9 across the join. The carry
        tables are built for the local y on the card (counted
        in ``built``, never in ``recomputed``); nothing is quantized or
        derived again. The cut is made once for each mesh and spec tree:
        a second call returns the first one's."""
        from repro_torch.dist import sharding

        key = (mesh, repr(specs))
        if key in self.cuts:
            return self.cuts[key]
        params = sharding.shard_tree(self.params, specs, mesh)
        derived = {}
        for path, y in self.derived.items():
            spec = _spec_at(specs, path)
            w = _leaf_at(params, path)
            if spec is None or not isinstance(w, torch.Tensor):
                continue
            local = sharding.shard_leaf(y, spec, mesh)
            n = local.shape[-1]
            if n != y.shape[-1]:                  # a copy: N was cut
                local[..., 0] = w[..., 0].to(local.dtype)
                step = n // getattr(spec, "blocks", 1)
                for j in range(step, n, step):
                    local[..., j] = (w[..., j].to(local.dtype)
                                     - w[..., j - 1].to(local.dtype))
            derived[path] = local
        pm = dataclasses.replace(self, params=params, derived=derived,
                                 carry={}, built={}, cuts={})
        pm.built = {"y": 0, "carry": pm.build_carry()}
        pm.baseline = counters_snapshot()
        self.cuts[key] = pm
        return pm

    # -- persistence -------------------------------------------------------
    def save(self, directory, *, overwrite: bool = True) -> Path:
        """Atomic directory write: everything lands in ``<dir>.tmp`` first,
        then one rename commits, so a killed writer leaves no torn artifact
        at the final path. Returns the path."""
        final = Path(directory)
        tmp = final.with_name(final.name + ".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        leaves: list = []
        tree = _encode({"params": self.params, "derived": self.derived},
                       leaves)
        for i, t in enumerate(leaves):
            np.save(tmp / f"arr_{i:05d}.npy", _to_numpy(t))
        manifest = {
            "version": _VERSION,
            "kind": self.kind,
            "device": self.device,
            "quantized": self.quantized,
            "schedule": self.schedule,
            "meta": self.meta,
            "tree": tree,
            "n_arrays": len(leaves),
            "time": time.time(),
        }
        (tmp / _MANIFEST).write_text(json.dumps(manifest) + "\n")
        if final.exists():
            if not overwrite:
                raise FileExistsError(f"artifact already exists at {final}")
            shutil.rmtree(final)
        tmp.rename(final)
        return final

    def nbytes(self) -> int:
        """Bytes of the tensors :meth:`save` writes."""
        leaves: list = []
        _encode({"params": self.params, "derived": self.derived}, leaves)
        return sum(t.numel() * t.element_size() for t in leaves)


def load(directory, *, device: Optional[str] = None,
         map_location=None) -> PreparedModel:
    """Load an artifact with the zero-recompute guarantee onto
    ``map_location`` (``None``: the card; tests pass ``"cpu"``).

    ``device`` overrides the device kind the schedule slice is checked
    against (the reference's argument). The same kind: the slice is
    installed into the process tune cache in memory (the cache file is not
    rewritten). Another kind: the slice is dropped with a one-time warning.
    The loaded y deltas are seeded into the module memo; on the card their
    carry tables are built here, and a tied unembed's y the artifact lacks
    is derived here (both counted in ``built``, neither in ``recomputed``).
    Corruption quarantines the directory to ``<dir>.corrupt`` and raises
    :class:`ArtifactError`.
    """
    path = Path(directory)
    dev = compat.resolve_device(map_location)
    try:
        manifest = json.loads((path / _MANIFEST).read_text())
        if manifest.get("version") != _VERSION:
            raise ValueError(
                f"artifact version {manifest.get('version')!r} != {_VERSION}")
        if manifest.get("kind") not in ("lm", "vision"):
            raise ValueError(f"bad artifact kind {manifest.get('kind')!r}")
        n = int(manifest["n_arrays"])
        leaves = [np.load(path / f"arr_{i:05d}.npy", mmap_mode="r")
                  for i in range(n)]
        obj = _decode(manifest["tree"], leaves, dev)
        del leaves
        params, derived = obj["params"], obj["derived"]
    except ArtifactError:
        raise
    except Exception as e:
        if path.exists():
            corrupt = path.with_name(path.name + ".corrupt")
            shutil.rmtree(corrupt, ignore_errors=True)
            where = ""
            try:
                path.rename(corrupt)
                where = f" (quarantined to {corrupt})"
            except OSError:
                pass
            raise ArtifactError(
                f"corrupt prepared artifact at {path}{where}: {e}") from e
        raise ArtifactError(f"no prepared artifact at {path}") from e

    kind = device or compat.device_kind()
    schedule = manifest.get("schedule") or {}
    if manifest["device"] != kind:
        if schedule:
            key = (str(path), manifest["device"], kind)
            if key not in _warned_drops:
                _warned_drops.add(key)
                log.warning(
                    "prepared artifact %s was tuned for device_kind=%r but "
                    "this process runs %r: dropping its %d schedule entries "
                    "(weights/y-deltas still apply; re-tune with "
                    "`python -m repro_torch.launch.tune` for this device)",
                    path, manifest["device"], kind, len(schedule))
            schedule = {}
    elif schedule:
        tune.get_cache().merge_entries(schedule)

    built = {"y": 0, "carry": 0}
    if derived and TIED_UNEMBED not in derived and _tied(params):
        # outside any memo: the load's own derivation, not a recompute
        derived[TIED_UNEMBED] = fip.make_y(params["embed"]["table"].T)
        built["y"] += 1
    pm = PreparedModel(
        kind=manifest["kind"], device=manifest["device"],
        quantized=bool(manifest["quantized"]), params=params,
        derived=derived, schedule=schedule, meta=manifest.get("meta") or {})
    built["carry"] = pm.build_carry()
    pm.built = built
    pm.seed_into(compat.derived)
    pm.baseline = counters_snapshot()
    return pm


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def _ready(pm: PreparedModel) -> PreparedModel:
    """Count the y deltas just derived, build their carry tables on the
    card, seed the module memo, and start the zero-recompute baseline."""
    compat.computed_by_tag[Y_TAG] = (compat.computed_by_tag.get(Y_TAG, 0)
                                     + len(pm.derived))
    compat.computed_by_tag[CARRY_TAG] = (
        compat.computed_by_tag.get(CARRY_TAG, 0) + pm.build_carry())
    pm.seed_into(compat.derived)
    pm.baseline = counters_snapshot()
    return pm


def prepare_lm(params, *, quantized: bool = True, dtype=torch.int8,
               y_deltas: bool = True, device: Optional[str] = None,
               name: Optional[str] = None) -> PreparedModel:
    """Prepare a language-model param tree for serving, on the device its
    tensors live on.

    * ``quantized``: attach per-channel int8 ``q`` entries (Eq. 15 folded
      beta, colsums, Eq. 20 zero points) beside every even-K dense ``w``;
    * ``y_deltas``: the Eq. 9 y deltas of every FFIP operand of the tier
      (the int8 codes' when quantized, else the float weights'), and the
      tied unembed's; on the card their carry tables too;
    * the current ``repro_torch.tune`` schedule slice for ``device`` (a
      device kind; default this process's) rides along.
    """
    kind = device or compat.device_kind()
    with torch.no_grad():
        p = (quant.attach_quantized_weights(params, dtype=dtype)
             if quantized else params)
        derived: Dict[str, Any] = {}
        if y_deltas:
            for wpath, w in _ffip_operands(p, quantized):
                derived[wpath] = _make_y_nd(w)
            if _tied(p):
                derived[TIED_UNEMBED] = fip.make_y(p["embed"]["table"].T)
        return _ready(PreparedModel(
            kind="lm", device=kind, quantized=quantized, params=p,
            derived=derived,
            schedule=tune.get_cache().entries_for_device(kind),
            meta={"name": name, "dtype": str(dtype).removeprefix("torch."),
                  "y_deltas": y_deltas}))


def prepare_vision(model, params, *, quantized: bool = True,
                   dtype=torch.int8, bn_stats=None,
                   device: Optional[str] = None,
                   name: Optional[str] = None) -> PreparedModel:
    """Prepare a vision model (its layer list and the parallel params):
    BN folded into the convs when ``bn_stats`` is given, then each conv's
    and even-K FC's int8 entry (``vision.models.attach_quantized``), and
    the y deltas of each even-K FC's FFIP operand (the int8 codes' when
    quantized). K7 derives its conv stacks itself, as the reference's
    artifact carries none."""
    from repro_torch.vision import layers as vl
    from repro_torch.vision import models as vm

    kind = device or compat.device_kind()
    p = list(params)
    folded = 0 if bn_stats is None else sum(bn is not None
                                            for bn in bn_stats)
    with torch.no_grad():
        if quantized:
            p = vm.attach_quantized(model, p, bn_stats=bn_stats, dtype=dtype)
        elif bn_stats is not None:
            if len(bn_stats) != len(p):
                raise ValueError("bn_stats must be parallel to params")
            p = [vl.fold_bn(lp, bn) if bn is not None else lp
                 for lp, bn in zip(p, bn_stats)]
        derived: Dict[str, Any] = {}
        for i, (layer, lp) in enumerate(zip(model, p)):
            if isinstance(layer, vm.FC) and lp["w"].shape[-2] % 2 == 0:
                if quantized and "q" in lp:
                    derived[f"{i}/q/qw"] = fip.make_y(lp["q"]["qw"])
                else:
                    derived[f"{i}/w"] = fip.make_y(lp["w"])
        return _ready(PreparedModel(
            kind="vision", device=kind, quantized=quantized, params=p,
            derived=derived,
            schedule=tune.get_cache().entries_for_device(kind),
            meta={"name": name, "dtype": str(dtype).removeprefix("torch."),
                  "bn_folded": folded}))
