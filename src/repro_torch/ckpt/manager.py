"""Checkpointing: atomic commit, async writer, keep-N GC, restore onto the
model's device. Counterpart of ``repro/ckpt/manager.py``, with the same
on-disk layout, so a checkpoint written by one package restores in the
other:

    <dir>/step_000123.tmp/...      (in flight)
    <dir>/step_000123/manifest.json
    <dir>/step_000123/arr_00000.npy ...

Leaves go in the reference's flatten order (dict keys sorted; an
``AdamWState`` as step, m, v). bf16 leaves are stored as their uint16 bits
with ``"bfloat16"`` in the manifest's ``dtypes``, the way ``bridge.py``
carries bf16, and a file whose manifest says ``bfloat16`` is read the same
way (the reference's own bf16 files hold the same two bytes per element).

A checkpoint is valid iff its directory has no ``.tmp`` suffix (atomic
rename on completion). Restore picks the latest valid step; an interrupted
write is removed by the next save.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.optim.adamw import tree_leaves, tree_unflatten

PyTree = Any


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _from_numpy(arr: np.ndarray, dtype_name: str, like: torch.Tensor
                ) -> torch.Tensor:
    if dtype_name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(dtype=like.dtype, device=like.device)


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        name = type(tree).__name__
        return f"{name}(" + ", ".join(_structure(t) for t in tree) + ")"
    return "*"


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: PyTree, *, extra: Optional[dict] = None,
             block: bool = False) -> None:
        """Copy to host memory now, write on a thread (one write in flight
        at a time)."""
        leaves = tree_leaves(tree)
        host = [_to_numpy(t) for t in leaves]          # device -> host now
        meta = {
            "step": step,
            "treedef": _structure(tree),
            "n_leaves": len(host),
            "time": time.time(),
            "extra": extra or {},
            "shapes": [list(t.shape) for t in leaves],
            "dtypes": [_dtype_name(t) for t in leaves],
        }
        self.wait()

        def write():
            tmp = self.dir / f"step_{step:08d}.tmp"
            final = self.dir / f"step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for i, arr in enumerate(host):
                np.save(tmp / f"arr_{i:05d}.npy", arr)
            (tmp / "manifest.json").write_text(json.dumps(meta))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)                          # atomic commit
            self._gc()

        if self.async_save and not block:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        # drop stale .tmp dirs and keep the newest N valid checkpoints
        for tmp in self.dir.glob("*.tmp"):
            shutil.rmtree(tmp, ignore_errors=True)
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: PyTree, *, step: Optional[int] = None
                ) -> tuple:
        """Restore into the structure of ``template``: each leaf takes its
        template leaf's dtype and device (the model's device). Returns (tree,
        extra)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        meta = json.loads((d / "manifest.json").read_text())
        leaves = tree_leaves(template)
        if meta["n_leaves"] != len(leaves):
            raise ValueError(f"tree mismatch: checkpoint has "
                             f"{meta['n_leaves']} leaves, template "
                             f"{len(leaves)}")
        out = []
        for i, tmpl in enumerate(leaves):
            arr = np.load(d / f"arr_{i:05d}.npy")
            if list(arr.shape) != list(tmpl.shape):
                raise ValueError(f"leaf {i}: checkpoint shape {arr.shape}, "
                                 f"template {tuple(tmpl.shape)}")
            out.append(_from_numpy(arr, meta["dtypes"][i], tmpl))
        return tree_unflatten(template, out), meta["extra"]
