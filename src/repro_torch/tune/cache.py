"""Persistent schedule cache for the kernel autotuner, a copy of
``repro/tune/cache.py`` (host-only code: the port keeps its own copy).

One JSON file maps cache keys (``kernel|algo|dtype|shape-bucket|
device_kind`` strings) to tuned schedules: block sizes plus the
measurements that chose them. The offline tuner
(``python -m repro_torch.launch.tune``) writes it and every
``GemmConfig(block="auto")`` lookup reads it; an in-process LRU sits on top
so lookups on the serving path never touch the filesystem after the first.
The format, version, key, environment variable and default path are the
reference's, so each package reads the other's file: dtype names are the
reference's strings (``float32``, ``bfloat16``, ``int8``) and the device is
``kernels.compat.device_kind()`` (``cpu`` on the host for both).

Robustness contract (tests/test_torch_tune.py):
  * round-trip: write -> new instance -> lookup returns the identical
    schedule with zero re-measurement;
  * corruption: an unreadable/garbage file is moved aside to ``*.corrupt``
    and the cache restarts empty (a tuner run then rebuilds it), never a
    crash;
  * writes are atomic (tmp file + rename) so a killed tuner can't corrupt a
    good cache; a save merges the entries already on disk first.

Location: ``$REPRO_TUNE_CACHE`` if set, else
``$XDG_CACHE_HOME|~/.cache / repro / tune_schedules.json``.
"""
from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Optional

_VERSION = 1


def _valid_entry(v) -> bool:
    return (isinstance(v, dict) and isinstance(v.get("blocks"), dict)
            and all(isinstance(x, int) for x in v["blocks"].values()))


def _read_entries(path: Path) -> Dict[str, dict]:
    """Parse a cache file into its valid entries; raises on corruption."""
    raw = json.loads(path.read_text())
    entries = raw["entries"]
    if raw.get("version") != _VERSION or not isinstance(entries, dict):
        raise ValueError("schedule cache version/shape mismatch")
    return {k: v for k, v in entries.items() if _valid_entry(v)}


def default_cache_path() -> Path:
    env = os.environ.get("REPRO_TUNE_CACHE")
    if env:
        return Path(env)
    base = Path(os.environ.get("XDG_CACHE_HOME", str(Path.home() / ".cache")))
    return base / "repro" / "tune_schedules.json"


def make_key(kernel: str, algo: str, dtype: str, shape_bucket: str,
             device: str) -> str:
    return "|".join((kernel, algo, dtype, shape_bucket, device))


class ScheduleCache:
    """JSON-file-backed schedule store with a bounded in-process LRU on top.

    ``_entries`` mirrors the whole file (entries are ~100 bytes each; the file
    is the source of truth and is rewritten whole on save). ``_lru`` is the
    read cache: lookups promote their key, and it is bounded so a pathological
    sweep over thousands of distinct shapes cannot grow lookup state without
    bound — evicted keys simply fall back to the ``_entries`` dict once.
    """

    def __init__(self, path: Optional[os.PathLike] = None, *,
                 lru_size: int = 1024):
        self.path = Path(path) if path is not None else default_cache_path()
        self.lru_size = lru_size
        self.recovered = False          # True if a corrupt file was replaced
        self._entries: Dict[str, dict] = {}
        self._lru: "OrderedDict[str, dict]" = OrderedDict()
        self._loaded = False
        self._lock = threading.Lock()

    # -- persistence -------------------------------------------------------
    def _load_locked(self):
        if self._loaded:
            return
        self._loaded = True
        try:
            self._entries = _read_entries(self.path)
        except FileNotFoundError:
            self._entries = {}
        except Exception:
            # Corrupted cache: recover to empty, keep the evidence aside so a
            # bad deploy is debuggable, and let the next save rewrite cleanly.
            self.recovered = True
            self._entries = {}
            try:
                self.path.rename(self.path.with_name(self.path.name +
                                                     ".corrupt"))
            except OSError:
                pass

    def save(self):
        with self._lock:
            self._load_locked()
            # Re-read and merge the on-disk entries before writing: two
            # tuner processes sharing a path (different archs, tune CLI +
            # gemm_micro) must not erase each other's buckets. Our in-memory
            # entries win per KEY; the atomic tmp+rename below only prevents
            # torn files, not this lost-update race.
            try:
                self._entries = {**_read_entries(self.path), **self._entries}
            except FileNotFoundError:
                pass   # nothing on disk yet: ours is the truth
            except Exception:
                # Corrupt on-disk file at SAVE time (e.g. another process
                # crashed mid-write before the atomic rename existed, or the
                # file was hand-edited). Overwriting it here would DESTROY
                # the evidence the load-time path carefully preserves —
                # quarantine it the same way before rewriting cleanly.
                self.recovered = True
                try:
                    self.path.rename(self.path.with_name(self.path.name +
                                                         ".corrupt"))
                except OSError:
                    pass
            payload = {"version": _VERSION, "entries": self._entries}
            self.path.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.path.with_name(self.path.name + ".tmp")
            tmp.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")
            tmp.replace(self.path)

    # -- access ------------------------------------------------------------
    def _touch_locked(self, key: str, value: dict):
        self._lru[key] = value
        self._lru.move_to_end(key)
        while len(self._lru) > self.lru_size:
            self._lru.popitem(last=False)

    def lookup(self, key: str) -> Optional[dict]:
        with self._lock:
            hit = self._lru.get(key)
            if hit is not None:
                self._lru.move_to_end(key)
                return hit
            self._load_locked()
            hit = self._entries.get(key)
            if hit is not None:
                self._touch_locked(key, hit)
            return hit

    def put(self, key: str, value: dict, *, persist: bool = True):
        with self._lock:
            self._load_locked()
            self._entries[key] = value
            self._touch_locked(key, value)
        if persist:
            self.save()

    def keys(self):
        with self._lock:
            self._load_locked()
            return sorted(self._entries)

    # -- artifact integration (repro_torch.prepare) ------------------------------
    def entries_for_device(self, device: str) -> Dict[str, dict]:
        """Deep-copied slice of entries keyed to one ``device_kind`` — the
        export path: ``repro_torch.prepare`` bundles this slice with the weights so
        a warm start on the same device kind never re-tunes."""
        with self._lock:
            self._load_locked()
            return {k: json.loads(json.dumps(v))
                    for k, v in self._entries.items()
                    if k.rsplit("|", 1)[-1] == device}

    def merge_entries(self, entries: Dict[str, dict], *,
                      persist: bool = False) -> int:
        """Install a slice (e.g. from a loaded artifact) into this cache;
        invalid entries are skipped, not fatal. Returns the count installed.
        In-memory by default — artifact schedules don't overwrite the user's
        cache file unless asked."""
        n = 0
        with self._lock:
            self._load_locked()
            for k, v in entries.items():
                if isinstance(k, str) and _valid_entry(v):
                    self._entries[k] = json.loads(json.dumps(v))
                    self._touch_locked(k, self._entries[k])
                    n += 1
        if persist and n:
            self.save()
        return n

    def __len__(self) -> int:
        with self._lock:
            self._load_locked()
            return len(self._entries)


_global: Optional[ScheduleCache] = None
_global_lock = threading.Lock()


def get_cache() -> ScheduleCache:
    """Process-wide cache at the current default path. Re-resolves the path on
    every call so tests (and CLIs) can retarget via $REPRO_TUNE_CACHE."""
    global _global
    path = default_cache_path()
    with _global_lock:
        if _global is None or _global.path != path:
            _global = ScheduleCache(path)
        return _global
