"""``repro_torch.tune``: kernel autotuning with a persistent device-keyed
cache, counterpart of ``repro/tune/__init__.py``.

  * :mod:`repro_torch.tune.space`   — the compiled tiles, the static default
    first, deterministically ordered;
  * :mod:`repro_torch.tune.measure` — the first call outside the timed
    region, CUDA-graph replays between events, median of k;
  * :mod:`repro_torch.tune.cache`   — the reference's JSON schedule cache,
    keyed ``kernel|algo|dtype|shape-bucket|device_kind``, with an LRU.

Consumers:
  * ``GemmConfig(block="auto")`` (``core/gemm.py``, ``vision/layers.py``)
    resolves ``(bm, bn, bk)`` for the cuda provider through
    :func:`lookup_gemm_blocks` / :func:`lookup_conv_blocks` on every call:
    a lookup, never a measurement, falling back to the static default on a
    miss with a one-time log and a ``stats`` count;
  * flash attention (``models/attention.py``) looks its one tile up the same
    way (:func:`lookup_flash_blocks`), so artifacts carry its key;
  * ``python -m repro_torch.launch.tune`` fills the cache for a model's GEMM
    shapes (:func:`tune_gemm`, :func:`tune_flash`), ``launch.vision --tune``
    for its convs (:func:`tune_conv`).

A cached entry whose blocks are not a tile the kernel is compiled for (a
``cpu`` entry that the JAX package tuned in the same file: both packages
read ``$REPRO_TUNE_CACHE`` and both call the host ``cpu``) is a miss with
its own one-time log: it never reaches a kernel.

Shape bucketing: each dim rounds up to a power of two, so one measured
schedule serves every shape in its bucket.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.compat import device_kind
from repro_torch.tune import measure, space
from repro_torch.tune.cache import ScheduleCache, get_cache, make_key

__all__ = [
    "ScheduleCache", "get_cache", "make_key", "device_kind",
    "gemm_key", "flash_key", "conv_key",
    "lookup_gemm_blocks", "lookup_flash_blocks", "lookup_conv_blocks",
    "tune_gemm", "tune_flash", "tune_conv", "stats", "reset_stats",
]

logger = logging.getLogger("repro_torch.tune")

# hit/miss telemetry for the "auto" path: a silent fallback to the static
# default is the failure this subsystem exists to remove, so misses are
# counted and logged once per distinct key
stats: Dict[str, int] = {"hits": 0, "misses": 0}
_warned_keys: set = set()


def reset_stats():
    stats["hits"] = 0
    stats["misses"] = 0
    _warned_keys.clear()


def _dtype_name(dtype) -> str:
    """The reference's dtype strings: ``float32``, ``bfloat16``, ``int8``."""
    return str(dtype).removeprefix("torch.")


def _bucket(*dims: int) -> Tuple[int, ...]:
    return tuple(space.round_up_pow2(d) for d in dims)


def gemm_key(algo: str, dtype, m: int, n: int, k: int, *,
             device: Optional[str] = None) -> str:
    mb, nb, kb = _bucket(m, n, k)
    return make_key("gemm", algo, _dtype_name(dtype), f"m{mb}n{nb}k{kb}",
                    device or device_kind())


def flash_key(dtype, bh: int, sq: int, sk: int, d: int, *,
              device: Optional[str] = None) -> str:
    bhb, sqb, skb = _bucket(bh, sq, sk)
    return make_key("flash_attention", "fwd", _dtype_name(dtype),
                    f"bh{bhb}sq{sqb}sk{skb}d{d}", device or device_kind())


def conv_key(algo: str, dtype, m: int, n: int, k: int, ckw: int, *,
             device: Optional[str] = None) -> str:
    """K7's key: the bucketed per-image GEMM view (m = OH*OW, n =
    Cout/groups, k = KH*KW*Cin_g) and the exact ``ckw`` = Cin_g*KW, as the
    reference keys its conv schedules."""
    mb, nb, kb = _bucket(m, n, k)
    return make_key("conv", algo, _dtype_name(dtype),
                    f"m{mb}n{nb}k{kb}ckw{ckw}", device or device_kind())


def _miss(key: str, why: str = "") -> None:
    stats["misses"] += 1
    if key not in _warned_keys:
        _warned_keys.add(key)
        if why:
            logger.info("tuned schedule for %s is %s; using static default "
                        "blocks (re-tune with `python -m "
                        "repro_torch.launch.tune`)", key, why)
        else:
            logger.info("no tuned schedule for %s; using static default "
                        "blocks (pre-populate with `python -m "
                        "repro_torch.launch.tune`)", key)
    return None


def _entry_blocks(key: str, entry, names, compiled) -> Optional[tuple]:
    if entry is None:
        return _miss(key)
    got = tuple(entry["blocks"].get(n) for n in names)
    if got not in compiled:
        return _miss(key, f"{got}, not a tile the kernel is compiled for")
    stats["hits"] += 1
    return got


# -- lookup (the hot path: never measures) ----------------------------------

def lookup_gemm_blocks(algo: str, dtype, m: int, n: int, k: int, *,
                       cache: Optional[ScheduleCache] = None,
                       ) -> Optional[Tuple[int, int, int]]:
    key = gemm_key(algo, dtype, m, n, k)
    entry = (cache if cache is not None else get_cache()).lookup(key)
    return _entry_blocks(key, entry, ("bm", "bn", "bk"),
                         space.compiled_tiles(algo, dtype))


def lookup_flash_blocks(dtype, bh: int, sq: int, sk: int, d: int, *,
                        cache: Optional[ScheduleCache] = None,
                        ) -> Optional[Tuple[int, int]]:
    key = flash_key(dtype, bh, sq, sk, d)
    entry = (cache if cache is not None else get_cache()).lookup(key)
    return _entry_blocks(key, entry, ("bq", "bk"), space.flash_candidates(
        space.round_up_pow2(sq), space.round_up_pow2(sk), dtype))


def lookup_conv_blocks(algo: str, dtype, m: int, n: int, k: int, ckw: int, *,
                       cache: Optional[ScheduleCache] = None,
                       ) -> Optional[Tuple[int, int, int]]:
    key = conv_key(algo, dtype, m, n, k, ckw)
    entry = (cache if cache is not None else get_cache()).lookup(key)
    return _entry_blocks(key, entry, ("bm", "bn", "bk"),
                         space.compiled_conv_tiles(algo))


# -- offline tuning ---------------------------------------------------------

def _entry(cands, best, best_t, trace, iters, names) -> dict:
    default_t = next((t["us"] for t in trace
                      if tuple(t["blocks"]) == tuple(cands[0])), None)
    return {"blocks": dict(zip(names, best)),
            "us": round(best_t * 1e6, 1),
            "default_blocks": dict(zip(names, cands[0])),
            "default_us": default_t,
            "candidates": len(trace),
            "iters": iters}


def tune_gemm(m: int, n: int, k: int, dtype, *, algo: str = "ffip",
              budget: int = 0, iters: int = 3, device=None,
              cache: Optional[ScheduleCache] = None,
              force: bool = False, persist: bool = True) -> dict:
    """Tune one GEMM shape bucket; returns (and persists) the cache entry.

    Measures at the BUCKET shape so the entry serves every member shape.
    ``budget`` limits how many candidates are tried (0 = all; the default is
    index 0, so budget=1 keeps it). A warm cache returns without measuring
    unless ``force``. ``persist=False`` defers the file write (the CLI saves
    once at the end of a sweep). ``device``: the card unless the caller asks
    for the CPU."""
    cache = cache if cache is not None else get_cache()
    key = gemm_key(algo, dtype, m, n, k)
    entry = None if force else cache.lookup(key)
    if entry is not None:
        return entry
    mb, nb, kb = _bucket(m, n, k)
    cands = space.gemm_candidates(mb, nb, kb, algo, dtype)
    if budget:
        cands = cands[:budget]
    best, best_t, trace = measure.best_gemm_blocks(
        algo, mb, kb, nb, dtype, cands, device=device, iters=iters)
    entry = _entry(cands, best, best_t, trace, iters, ("bm", "bn", "bk"))
    cache.put(key, entry, persist=persist)
    logger.info("tuned %s -> %s (%.1fus over %d candidates)", key,
                entry["blocks"], entry["us"], entry["candidates"])
    return entry


def tune_conv(batch: int, h: int, w: int, cin: int, cout: int, kh: int,
              kw: int, dtype, *, stride=1, pad=0, groups: int = 1,
              algo: str = "ffip", budget: int = 0, iters: int = 3,
              device=None, cache: Optional[ScheduleCache] = None,
              force: bool = False, persist: bool = True) -> dict:
    """Tune one K7 geometry; the same contract as :func:`tune_gemm`,
    measured at the real geometry and batch, keyed by the bucketed
    per-image GEMM view and the exact ``ckw``."""
    from repro_torch.core.im2col import as_pair, conv_out_hw
    cache = cache if cache is not None else get_cache()
    sh, sw = as_pair(stride)
    ph, pw = as_pair(pad)
    cin_g = cin // groups
    k = kh * kw * cin_g
    ckw = cin_g * kw
    oh, ow = conv_out_hw(h + 2 * ph, w + 2 * pw, kh, kw, (sh, sw))
    m, n = oh * ow, cout // groups
    key = conv_key(algo, dtype, m, n, k, ckw)
    entry = None if force else cache.lookup(key)
    if entry is not None:
        return entry
    cands = space.conv_candidates(batch * m, n, k, ckw, algo, groups=groups)
    if budget:
        cands = cands[:budget]
    best, best_t, trace = measure.best_conv_blocks(
        algo, batch, h, w, cin, kh, kw, cout, dtype, cands,
        stride=(sh, sw), pad=(ph, pw), groups=groups, device=device,
        iters=iters)
    entry = _entry(cands, best, best_t, trace, iters, ("bm", "bn", "bk"))
    entry["geometry"] = {"batch": batch, "h": h, "w": w, "cin": cin,
                         "cout": cout, "kh": kh, "kw": kw,
                         "stride": [sh, sw], "pad": [ph, pw],
                         "groups": groups}
    cache.put(key, entry, persist=persist)
    logger.info("tuned %s -> %s (%.1fus over %d candidates)", key,
                entry["blocks"], entry["us"], entry["candidates"])
    return entry


def tune_flash(bh: int, sq: int, sk: int, d: int, dtype=torch.bfloat16, *,
               budget: int = 0, iters: int = 3, device=None,
               cache: Optional[ScheduleCache] = None,
               force: bool = False, persist: bool = True) -> dict:
    """Tune one K4 shape bucket; the same contract as :func:`tune_gemm`.
    K4 has one tile for the dtype and Sq, so the entry records its time
    and that tile."""
    cache = cache if cache is not None else get_cache()
    key = flash_key(dtype, bh, sq, sk, d)
    entry = None if force else cache.lookup(key)
    if entry is not None:
        return entry
    bhb, sqb, skb = _bucket(bh, sq, sk)
    cands = space.flash_candidates(sqb, skb, dtype)
    if budget:
        cands = cands[:budget]
    best, best_t, trace = measure.best_flash_blocks(
        bhb, sqb, skb, d, dtype, cands, device=device, iters=iters)
    entry = _entry(cands, best, best_t, trace, iters, ("bq", "bk"))
    cache.put(key, entry, persist=persist)
    logger.info("tuned %s -> %s (%.1fus over %d candidates)", key,
                entry["blocks"], entry["us"], entry["candidates"])
    return entry
