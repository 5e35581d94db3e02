"""Serving runtime: slot-based continuous batching, counterpart of the
contiguous mode of ``repro/serve/batcher.py``.

A fixed pool of B slots; a request occupies a slot, its prompt prefills the
slot's cache rows, then all active slots decode in lockstep at their OWN
positions (a ``(B,)`` position vector). Finished slots refill from the queue.

* **Sampling on the device**: only int32 token ids cross to the host.
* **Fused multi-step decode**: ``decode_chunk`` steps per dispatch, each
  sampled token fed straight back; a finished slot freezes and rewrites its
  own row with identical values, so tokens match one-step-at-a-time decode.
* **Bucketed batched prefill**: prompts pad to power-of-2 buckets and
  same-bucket requests prefill together, straight into the shared slot cache
  under a row mask.

The K/V cache is updated IN PLACE (``models.attention._cache_write``): the
server only ever holds the newest cache, so no per-dispatch copy is kept.

``quantized=True`` serves through the int8 (F)FIP path (offline per-channel
weights, Eq. 15 folded beta, Eq. 20 zero-point adjuster, per-token-row
activations). ``gemm_impl="cuda"`` runs the projections through the
hand-written kernels; with ``gemm_algo="ffip"`` the Eq. 9 y-deltas of every
weight are computed once when serving starts, not per step, and the server
holds them: they are freed with it.

Paged caches, meshes, prepared artifacts and the ``repro.obs`` hooks come in
later slices; asking for one raises ``NotImplementedError``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.gemm import GemmConfig, use_gemm
from repro_torch.core.quant import attach_quantized_weights
from repro_torch.kernels import compat, ffip_gemm
from repro_torch.kernels.compat import resolve_device
from repro_torch.models.model import Model
from repro_torch.serve.lifecycle import (AdmissionImpossibleError,
                                         ServeStallError)

_MIN_BUCKET = 4


def _ffip_weights(node, quantized: bool):
    """Every dense weight (its int8 ``qw`` when quantized) that the forward
    hands the FFIP GEMM: those with an even contraction dim."""
    if not isinstance(node, dict):
        return
    if "w" in node and not isinstance(node["w"], dict):
        w = node["q"]["qw"] if quantized and "q" in node else node["w"]
        if w.shape[-2] % 2 == 0:
            yield w
        return
    for val in node.values():
        yield from _ffip_weights(val, quantized)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    eos_id: int = -1              # -1: never
    out_tokens: Optional[List[int]] = None
    t_submit: float = 0.0         # set by submit()
    t_first: float = 0.0          # set when the first token lands (TTFT)
    t_done: float = 0.0           # set when the request completes (e2e)
    itl_s: Optional[List[float]] = None   # per-token inter-token latency


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0                  # tokens currently in this slot's cache rows
    remaining: int = 0


class BatchServer:
    """Single-device continuous batcher over the contiguous slot cache."""

    def __init__(self, model: Model, *, batch_slots: int, max_len: int,
                 greedy: bool = True, quantized: bool = False,
                 gemm_algo: str = "ffip", gemm_impl: Optional[str] = None,
                 decode_chunk: int = 1,
                 device=None, paged: bool = False, mesh=None, prepared=None,
                 registry=None, tracer=None,
                 clock: Optional[Callable[[], float]] = None):
        for name, val in (("paged", paged), ("mesh", mesh),
                          ("prepared", prepared), ("registry", registry),
                          ("tracer", tracer)):
            if val:
                raise NotImplementedError(
                    f"BatchServer({name}=...) is not ported yet "
                    f"(contiguous single-device serving only)")
        if not greedy:
            raise NotImplementedError("only greedy decoding is implemented")
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, server on "
                             f"{self.device}")
        self.model = model
        self.b = batch_slots
        self.max_len = max_len
        self.decode_chunk = decode_chunk
        self.quantized = quantized
        self.tier = "int8" if quantized else "float"
        self._clock = clock if clock is not None else time.perf_counter
        self.slots = [_Slot() for _ in range(batch_slots)]
        self._queue: "collections.deque[Request]" = collections.deque()
        self._completed: List[Request] = []
        # idempotency: rid -> (payload key, tokens) for finished requests
        # (bounded LRU); duplicates of an INFLIGHT rid wait and complete from
        # the original's tokens without a second decode.
        self._results: "collections.OrderedDict[int, Tuple[tuple, List[int]]]" \
            = collections.OrderedDict()
        self._result_cache_size = 1024
        self._dup_waiters: Dict[int, List[Request]] = {}
        self._cached_hits: List[Request] = []
        self.cache = model.init_cache(batch_slots, max_len)
        if quantized or gemm_impl is not None:
            impl = gemm_impl or "torch"
            if impl not in ("torch", "ref", "cuda"):
                raise ValueError(f"gemm_impl must be torch, ref or cuda; "
                                 f"got {impl!r}")
            algo = gemm_algo if (quantized or impl == "cuda") else "baseline"
            self._gemm_cfg = GemmConfig(algo=algo, impl=impl,
                                        quantized=quantized)
        else:
            self._gemm_cfg = None
        # the server's own per-weight memo (y-deltas, contiguous copies of
        # weight views): what it prepares is freed with the server
        self._derived = compat.DerivedCache()
        self._prepared_params = None
        self._prepared_src = None
        self.stats: Dict[str, Any] = self._fresh_stats()

    @staticmethod
    def _fresh_stats() -> Dict[str, Any]:
        """Per-drain statistics (reset by :meth:`run_until_drained`)."""
        return {"prefill_s": 0.0, "decode_s": 0.0, "steps": 0,
                "prefill_tokens": 0, "decode_tokens": 0,
                "prefill_dispatches": 0, "decode_dispatches": 0,
                "host_bytes_prefill": 0, "host_bytes_decode": 0}

    # -- GEMM scope and run-ready params ------------------------------------
    def _gemm_scope(self):
        stack = contextlib.ExitStack()
        if self._gemm_cfg is not None:
            stack.enter_context(use_gemm(self._gemm_cfg))
        stack.enter_context(compat.use_derived(self._derived))
        stack.enter_context(torch.no_grad())
        return stack

    def _params_for(self, params):
        """The run-ready tree, built once per distinct params object: int8
        ``q`` entries attached when quantized, and for the FFIP kernels the
        y-deltas of every weight the forward will hand them, computed now
        into the server's memo (it keys on storage, so the per-layer views
        the forward slices later hit it)."""
        if self._gemm_cfg is None:
            return params
        if self._prepared_src is not params:
            self._derived.clear()
            with self._gemm_scope():
                p = (attach_quantized_weights(params) if self.quantized
                     else params)
                cfg = self._gemm_cfg
                if cfg.algo == "ffip" and cfg.impl == "cuda":
                    self._warm_y(p)
            self._prepared_params, self._prepared_src = p, params
        return self._prepared_params

    def _warm_y(self, p) -> None:
        for w in _ffip_weights(p, self.quantized):
            for view in (w if w.dim() == 3 else [w]):
                ffip_gemm.y_for(view)
        if self.model.cfg.tie_embeddings:
            ffip_gemm.y_for(p["embed"]["table"].T)

    # -- prefill -----------------------------------------------------------
    def _bucket_len(self, n: int) -> int:
        b = _MIN_BUCKET
        while b < n:
            b *= 2
        return min(b, self.max_len)

    @staticmethod
    def cache_rows(prompt_len: int, max_new_tokens: int) -> int:
        """Cache rows a request can ever occupy: the prompt plus one per
        decode step; the last sampled token is never written, so
        ``max_new_tokens`` need ``max_new_tokens - 1`` rows."""
        return prompt_len + max(max_new_tokens, 1) - 1

    @staticmethod
    def _req_key(req: Request) -> tuple:
        """Payload identity for idempotent rids."""
        return (np.asarray(req.prompt, np.int64).tobytes(),
                int(req.max_new_tokens), int(req.eos_id))

    def _find_inflight(self, rid: int) -> Optional[Request]:
        for r in self._queue:
            if r.rid == rid:
                return r
        for s in self.slots:
            if s.req is not None and s.req.rid == rid:
                return s.req
        return None

    def submit(self, req: Request):
        rows = self.cache_rows(len(req.prompt), req.max_new_tokens)
        if rows > self.max_len:
            raise AdmissionImpossibleError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) needs {rows} cache "
                f"rows (the last sampled token is never written) but "
                f"max_len is {self.max_len}")
        req.t_submit = self._clock()
        key = self._req_key(req)
        inflight = self._find_inflight(req.rid)
        if inflight is not None:
            if self._req_key(inflight) != key:
                raise AdmissionImpossibleError(
                    f"rid {req.rid} resubmitted with a different "
                    f"prompt/budget while the original is in flight")
            req.out_tokens = []
            self._dup_waiters.setdefault(req.rid, []).append(req)
            return
        hit = self._results.get(req.rid)
        if hit is not None:
            hkey, toks = hit
            if hkey != key:
                raise AdmissionImpossibleError(
                    f"rid {req.rid} resubmitted with a different "
                    f"prompt/budget than its cached completion")
            req.out_tokens = list(toks)
            req.t_first = req.t_done = self._clock()
            self._cached_hits.append(req)
            return
        req.out_tokens = []
        req.itl_s = []
        self._queue.append(req)

    def has_queued(self) -> bool:
        return bool(self._queue)

    def _finish(self, req: Request):
        req.t_done = self._clock()
        self._completed.append(req)
        self._results[req.rid] = (self._req_key(req), list(req.out_tokens))
        self._results.move_to_end(req.rid)
        while len(self._results) > self._result_cache_size:
            self._results.popitem(last=False)
        for w in self._dup_waiters.pop(req.rid, []):
            w.out_tokens = list(req.out_tokens)
            w.itl_s = None if req.itl_s is None else list(req.itl_s)
            w.t_first = req.t_first
            w.t_done = req.t_done
            self._completed.append(w)

    def take_completed(self) -> List[Request]:
        done, self._completed = self._completed, []
        return done

    def _place(self, slot_i: int, req: Request, first: int):
        req.out_tokens.append(first)
        req.t_first = self._clock()
        slot = self.slots[slot_i]
        if req.max_new_tokens <= 1 or first == req.eos_id:
            self._finish(req)          # done at prefill: slot stays free
            slot.req = None
            return
        slot.req = req
        slot.pos = len(req.prompt)
        slot.remaining = req.max_new_tokens - 1

    def _admit(self, params):
        while self._queue:
            free = [i for i, s in enumerate(self.slots) if s.req is None]
            if not free:
                return
            self._admit_bucket(params, free)

    def _admit_bucket(self, params, free: List[int]):
        """One batched prefill dispatch: the head-of-queue request's bucket
        plus every queued request sharing it (FIFO), up to the free slots.
        The forward runs over all B slot rows; masked-out rows keep their
        cache content."""
        bucket = self._bucket_len(len(self._queue[0].prompt))
        batch: List[Request] = []
        kept: List[Request] = []
        while self._queue and len(batch) < len(free):
            r = self._queue.popleft()
            if self._bucket_len(len(r.prompt)) == bucket:
                batch.append(r)
            else:
                kept.append(r)
        self._queue.extendleft(reversed(kept))

        tokens = np.zeros((self.b, bucket), np.int64)
        lengths = np.ones((self.b,), np.int64)
        mask = np.zeros((self.b,), bool)
        for slot_i, req in zip(free, batch):
            n = len(req.prompt)
            tokens[slot_i, :n] = req.prompt
            lengths[slot_i] = n
            mask[slot_i] = True
            self.stats["prefill_tokens"] += n
        t0 = self._clock()
        dev = self.device
        with self._gemm_scope():
            self.cache, first = self.model.prefill_sample(
                params, torch.from_numpy(tokens).to(dev), self.cache,
                torch.from_numpy(lengths).to(dev),
                torch.from_numpy(mask).to(dev))
        first_h = first.cpu().numpy()
        self.stats["prefill_s"] += self._clock() - t0
        self.stats["prefill_dispatches"] += 1
        self.stats["host_bytes_prefill"] += int(first_h.nbytes)
        for slot_i, req in zip(free, batch):
            self._place(slot_i, req, int(first_h[slot_i]))

    # -- decode ------------------------------------------------------------
    def step(self, params) -> int:
        """Admit what fits, then one fused decode dispatch
        (``decode_chunk`` lockstep steps) over all active slots. Returns the
        number of active decode slots."""
        if self._cached_hits:
            self._completed.extend(self._cached_hits)
            self._cached_hits.clear()
        params = self._params_for(params)
        self._admit(params)
        active = [i for i, s in enumerate(self.slots)
                  if s.req is not None and s.remaining > 0]
        if not active:
            return 0
        last = np.zeros((self.b,), np.int64)
        pos = np.zeros((self.b,), np.int64)
        live = np.zeros((self.b,), bool)
        rem = np.zeros((self.b,), np.int64)
        eos = np.full((self.b,), -1, np.int64)
        for i in active:
            slot = self.slots[i]
            last[i] = slot.req.out_tokens[-1]
            pos[i] = slot.pos
            live[i] = True
            rem[i] = slot.remaining
            eos[i] = slot.req.eos_id
        # per-slot positions: slot i writes K/V at row pos[i]; inactive and
        # frozen slots rewrite their own row with unchanged values.
        dev = self.device
        t0 = self._clock()
        with self._gemm_scope():
            self.cache, toks = self.model.sample_steps(
                params, torch.from_numpy(last).to(dev), self.cache,
                torch.from_numpy(pos).to(dev), torch.from_numpy(live).to(dev),
                torch.from_numpy(rem).to(dev), torch.from_numpy(eos).to(dev),
                steps=self.decode_chunk)
        toks_h = toks.cpu().numpy().astype(np.int32)     # (chunk, B)
        dt = self._clock() - t0
        self.stats["decode_s"] += dt
        self.stats["decode_dispatches"] += 1
        self.stats["host_bytes_decode"] += int(toks_h.nbytes)
        # replay the device's (eos, remaining) bookkeeping to see which of
        # the chunk's tokens were emitted; each is charged dt / chunk.
        step_dt = dt / toks_h.shape[0]
        for j in range(toks_h.shape[0]):
            emitted = 0
            for i in active:
                slot = self.slots[i]
                if slot.req is None:
                    continue
                nxt = int(toks_h[j, i])
                slot.req.out_tokens.append(nxt)
                if slot.req.itl_s is not None:
                    slot.req.itl_s.append(step_dt)
                slot.pos += 1
                slot.remaining -= 1
                emitted += 1
                if slot.remaining <= 0 or nxt == slot.req.eos_id:
                    self._finish(slot.req)
                    slot.req = None
            if emitted:
                self.stats["steps"] += 1
                self.stats["decode_tokens"] += emitted
        return len(active)

    def run_until_drained(self, params, *, max_steps: int = 10_000
                          ) -> List[Request]:
        """Step until the queue and all slots drain; returns the finished
        requests in completion order. Hitting ``max_steps`` with requests
        still live raises :class:`ServeStallError`."""
        self._completed = []
        self.stats = self._fresh_stats()
        for _ in range(max_steps):
            if self.step(params) == 0 and not self._queue:
                break
        else:
            stuck: Dict[int, str] = {}
            for r in self._queue:
                stuck[r.rid] = "queued (never admitted)"
            for i, s in enumerate(self.slots):
                if s.req is not None:
                    stuck[s.req.rid] = (f"slot {i}: pos={s.pos} "
                                        f"remaining={s.remaining}")
            if stuck:
                raise ServeStallError(
                    f"run_until_drained hit max_steps={max_steps} with "
                    f"{len(stuck)} request(s) still live", stuck=stuck)
        return self._completed
