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
  under a row mask. That needs a sequence axis in every cache leaf; an SSM
  state and an encoder's cross K/V have none, so such a model, or
  ``prefill_buckets=False``, takes the per-slot scatter prefill instead: a
  batch-1 forward into a fresh cache, copied into the slot along each cache
  leaf's own batch axis (axis 1 of an ``(L, B, ...)`` leaf, axis 2 of the
  hybrid's ``(n_groups, period, B, ...)`` ones).

The K/V cache is updated IN PLACE (``models.attention._cache_write``): the
server only ever holds the newest cache, so no per-dispatch copy is kept.

``quantized=True`` serves through the int8 (F)FIP path (offline per-channel
weights, Eq. 15 folded beta, Eq. 20 zero-point adjuster, per-token-row
activations). ``gemm_impl="cuda"`` runs the projections through the
hand-written kernels; with ``gemm_algo="ffip"`` the Eq. 9 y-deltas of every
weight are computed once when serving starts, not per step, and the server
holds them: they are freed with it.

**Paged mode** (``paged=True``): the per-slot ``slots x max_len`` cache is
replaced by a shared page POOL per cache leaf (``num_pages`` pages of
``page_size`` tokens) addressed through a per-slot ``(B, max_pages)`` page
table. Pages are allocated as a sequence grows; full prompt pages are keyed
by a chained hash and SHARED across requests with identical prefixes
(refcounted, copied on write when a shared page would be written); prompts
prefill in page-aligned CHUNKS, one chunk per mid-prefill slot per step,
interleaved with the decode dispatch. ``paged_attention="flash"`` attends
through the paged kernel (K5); ``"gather"`` runs the contiguous decode math
over a gathered view, so its tokens match ``paged=False``.

**Observability** (``repro_torch.obs``, as the reference's): every time
read goes through the injected ``clock`` (default
:func:`repro_torch.obs.default_clock`), so a ``FakeClock`` makes stats,
histograms and span timestamps deterministic. The server mirrors its work
into ``serve_*`` counters and histograms labelled ``{replica, phase}``,
windowed TTFT and inter-token latency labelled ``{replica, tier}``
(``obs_window_s``), and request / prefill / prefill_chunk / decode spans in
a bounded ring (``trace_capacity``); :attr:`BatchServer.events` is a view
of that ring. The reference's ``serve_compiles_total`` and ``compiles``
count jit traces; the port dispatches eagerly and has neither. The router
(:mod:`repro_torch.serve.router`) relabels each replica with
:meth:`BatchServer.set_obs_labels` and reads :meth:`free_slots`,
:meth:`outstanding_rows`, :meth:`page_headroom` and :meth:`request_phase`.

``gemm_block`` (``"auto"`` or an explicit ``(bm, bn, bk)``) picks the
kernels' tiles: ``"auto"`` from the ``repro_torch.tune`` schedule cache (and
K4's one tile, so its key is looked up too); explicit blocks need
``gemm_impl="cuda"``. ``prepared`` (a ``repro_torch.prepare`` artifact)
serves its params, and the server seeds its own memo from the artifact's y
deltas and carry tables: the first prefill derives nothing. A router's
replicas of one tier share one artifact.

**Tensor parallelism** (``mesh=``, a connected
``repro_torch.dist.Mesh``, one process a rank): the reference's
``BatchServer(mesh=)`` on its ``"model"`` axis. Params and the cache are
cut through the ``repro_torch.dist`` rule engine once for each distinct
tree (column- and row-parallel projections, whole heads, KV heads where
they divide, the expert banks by ``moe_partition``, "expert" or "ffn"),
and every dispatch runs under the ambient mesh, so the model code reduces
its partial results over the ranks; the kernels run on each rank's local
shard. Every rank must run the same schedule: it submits the same requests
in the same order, and no decision here reads a clock or another value
that differs between ranks. The int8 layers give the single device's bits;
what a partition sums in f32 in another order (a float row-parallel
layer, the "ffn" experts' partials) rounds differently.
Every family serves on a mesh. The SSM and hybrid stacks: each rank holds
its piece of every Mamba mixer's d_inner (or heads) and of its streaming
state, runs K6 (Mamba1 prefill) on its own channels, and takes the scatter
prefill in the same order as every other rank. The encoder-decoder: each
rank holds its heads of the encoder's attention, of every decoder layer's
cross attention and of the cached cross K/V. ``paged=True`` with ``mesh=``
raises ``NotImplementedError``, as the reference's does.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.core.gemm import GemmConfig, use_gemm
from repro_torch.core.quant import attach_quantized_weights
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding
from repro_torch.kernels import compat, ffip_gemm
from repro_torch.kernels.compat import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.obs.trace import Tracer
from repro_torch.serve.lifecycle import (AdmissionImpossibleError,
                                         ServeStallError)
from repro_torch.serve.paged import (PageAllocator, PrefixIndex, page_keys,
                                     partial_key)

Tensor = torch.Tensor

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


def _cache_supports_buckets(model: Model, batch: int, max_len: int) -> bool:
    """Bucketed prefill needs every cache leaf to have a sequence axis (one
    that scales with max_len), so a masked prefill at offset 0 commits
    exactly the prompt rows. SSM states and encoder cross-K/V leaves have
    none, so those models take the per-slot scatter prefill. Decided from
    the cache's shapes, as the reference decides, on the meta device
    (nothing is allocated)."""
    meta = Model(model.cfg, device="meta")
    a = _leaves(meta.init_cache(batch, max_len))
    b = _leaves(meta.init_cache(batch, max_len + 1))
    return all(x.shape != y.shape for x, y in zip(a, b))


def _cache_batch_axes(model: Model, batch: int, max_len: int) -> List[int]:
    """The batch axis of every cache leaf (in ``_leaves`` order), found from
    shapes as the reference finds it: the axis whose size changes with
    init_cache's batch argument (on the meta device: nothing is allocated).
    Unlike assuming axis 1, this holds for the hybrid's ``(n_groups,
    period, B, ...)`` leaves, and never mistakes a layer, head or state axis
    that happens to equal the slot count for the batch."""
    meta = Model(model.cfg, device="meta")
    a = _leaves(meta.init_cache(batch, max_len))
    b = _leaves(meta.init_cache(batch + 1, max_len))
    return [next(i for i, (m, n) in enumerate(zip(x.shape, y.shape)) if m != n)
            for x, y in zip(a, b)]


def _scatter_slot(cache: dict, one: dict, axes: List[int], slot: int):
    """Copy the batch-1 cache ``one`` into row ``slot`` of ``cache``, along
    each leaf's batch axis, in place."""
    for full, part, axis in zip(_leaves(cache), _leaves(one), axes):
        full.select(axis, slot).copy_(part.select(axis, 0))


def _leaves(tree) -> List[Tensor]:
    if isinstance(tree, dict):
        return [leaf for val in tree.values() for leaf in _leaves(val)]
    return [tree]


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
class _PagedSeq:
    """Paged-mode bookkeeping for one in-flight request."""
    n: int                        # prompt length
    pages: List[int]              # pool page ids for logical pages 0..k-1
    keys: List[bytes]             # chain keys of the FULL prompt pages
    pkey: Optional[bytes]         # key of the terminal partial page (if any)
    filled: int                   # leading prompt rows already in the pool
    compute_next: int             # next prompt token index to run
    shared_tail: bool             # pages[-1] attached shared -> COW on write
    reserve: int                  # pages reserved (admission) not yet alloc'd
    registered: int = 0           # full prompt pages published to the index


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0                  # tokens currently in this slot's cache rows
    remaining: int = 0
    seq: Optional[_PagedSeq] = None   # paged mode only


class BatchServer:
    """Continuous batcher over the contiguous slot cache or, with
    ``paged=True``, a shared page pool; with ``mesh=``, one rank of a
    tensor-parallel server."""

    def __init__(self, model: Model, *, batch_slots: int, max_len: int,
                 greedy: bool = True, quantized: bool = False,
                 gemm_algo: str = "ffip", gemm_impl: Optional[str] = None,
                 gemm_block=None,
                 decode_chunk: int = 1, prefill_buckets: bool = True,
                 device=None, paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 paged_attention: str = "gather",
                 prefix_sharing: bool = True, mesh=None,
                 moe_partition: str = "expert", prepared=None,
                 clock: Optional[Callable[[], float]] = None,
                 registry=None, tracer=None, trace_capacity: int = 4096,
                 obs_window_s: float = 30.0):
        if moe_partition not in ("expert", "ffn"):
            raise ValueError(f"moe_partition must be 'expert' or 'ffn', "
                             f"got {moe_partition!r}")
        if mesh is not None:
            if paged:
                raise NotImplementedError(
                    "paged=True with mesh= is not supported yet (the page "
                    "pool is host-managed per device); use the contiguous "
                    "cache for tensor-parallel serving")
            if mesh.size(dctx.MODEL) > 1 and not mesh.connected:
                raise ValueError(f"{mesh} is shape-only: tensor-parallel "
                                 f"serving needs a process group")
        if prepared is not None:
            if prepared.kind != "lm":
                raise ValueError(f"BatchServer needs an 'lm' artifact, got "
                                 f"{prepared.kind!r}")
            if quantized and not prepared.quantized:
                raise ValueError(
                    "quantized=True but the prepared artifact carries no "
                    "int8 weights: re-run `python -m "
                    "repro_torch.launch.prepare --quantized`")
        if not greedy:
            raise NotImplementedError("only greedy decoding is implemented")
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, server on "
                             f"{self.device}")
        self.model = model
        self.mesh = mesh
        self.moe_partition = moe_partition
        self.b = batch_slots
        self.max_len = max_len
        self.decode_chunk = decode_chunk
        self.paged = paged
        self.quantized = quantized   # the router's tier tag (shed policy)
        self.tier = "int8" if quantized else "float"
        self.obs_window_s = obs_window_s  # sliding-window span for TTFT/ITL
        # every time read goes through `_clock`: inject a FakeClock (as the
        # router takes) and stats, histograms and spans run on fake time
        self._clock = clock if clock is not None else obs.default_clock
        self.registry = (registry if registry is not None
                         else obs.get_registry())
        self.tracer = tracer if tracer is not None else Tracer(
            clock=self._clock, capacity=trace_capacity)
        # the router relabels per replica (set_obs_labels) and sets
        # trace_requests=False: it owns the per-rid root "request" span
        self.trace_requests = True
        self._req_spans: Dict[int, Any] = {}
        self.set_obs_labels({"replica": "solo"})
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
        if paged:
            if page_size < 1 or (page_size & (page_size - 1)):
                raise ValueError(f"page_size must be a power of two, "
                                 f"got {page_size}")
            if max_len % page_size:
                raise ValueError(f"max_len ({max_len}) must be a multiple of "
                                 f"page_size ({page_size})")
            if not T.paged_cache_supported(model.cfg):
                raise ValueError("paged=True requires a pure-attention "
                                 f"decoder (family={model.cfg.family!r})")
            if paged_attention not in ("gather", "flash"):
                raise ValueError(f"paged_attention must be 'gather' or "
                                 f"'flash', got {paged_attention!r}")
            self.page_size = page_size
            self.max_pages = max_len // page_size
            self.num_pages = (num_pages if num_pages is not None
                              else batch_slots * self.max_pages)
            self.prefill_chunk = prefill_chunk or max_len
            if (self.prefill_chunk % page_size
                    or not 0 < self.prefill_chunk <= max_len):
                raise ValueError(
                    f"prefill_chunk ({self.prefill_chunk}) must be a "
                    f"page-aligned length in (0, max_len]")
            self.paged_attention = paged_attention
            self.prefix_sharing = prefix_sharing
            self.alloc = PageAllocator(self.num_pages)
            self.prefix = PrefixIndex(self.alloc)
            self._reserved = 0          # pages promised to admitted requests
            self.cache = model.init_paged_cache(self.num_pages, page_size)
            self._bucketed = False
        else:
            self.cache = self._new_cache(batch_slots)
            self._bucketed = prefill_buckets and _cache_supports_buckets(
                model, batch_slots, max_len)
            self._batch_axes = _cache_batch_axes(model, batch_slots, max_len)
        # the GEMM provider of every dispatch; "auto" also looks up K4's
        # tile, which is why a config is built even on the torch provider
        if quantized or gemm_impl is not None or gemm_block is not None:
            impl = gemm_impl or "torch"
            if impl not in ("torch", "ref", "cuda"):
                raise ValueError(f"gemm_impl must be torch, ref or cuda; "
                                 f"got {impl!r}")
            if (gemm_block is not None and gemm_block != "auto"
                    and impl != "cuda"):
                # explicit blocks reach a kernel only through the cuda
                # provider; elsewhere they would be a silent no-op
                raise ValueError(
                    "explicit gemm_block requires gemm_impl='cuda' "
                    "(block='auto' alone is fine: it also looks up flash "
                    "attention's tile)")
            algo = gemm_algo if (quantized or impl == "cuda") else "baseline"
            self._gemm_cfg = GemmConfig(algo=algo, impl=impl,
                                        quantized=quantized,
                                        block=gemm_block)
        else:
            self._gemm_cfg = None
        self.prepared = prepared
        # the server's own per-weight memo (y-deltas, carry tables,
        # contiguous copies of weight views): what it prepares is freed with
        # the server; an artifact's derived values are seeded into it
        self._derived = compat.DerivedCache()
        self._prepared_params = None
        self._prepared_src = None
        self._local_prepared = None     # a mesh's cut of ``prepared``
        self.stats: Dict[str, Any] = self._fresh_stats()

    @staticmethod
    def _fresh_stats() -> Dict[str, Any]:
        """Per-drain statistics: :meth:`run_until_drained` replaces
        ``self.stats`` with a fresh copy at entry, so after a drain it
        describes that drain only (``pages_peak`` is the peak within it; the
        allocator's lifetime peak is ``alloc.peak_in_use``). What spans
        drains lives in the ``repro_torch.obs`` metrics (``self.registry``)
        and the span ring (``self.tracer``). :meth:`step`, as the router
        calls it, resets nothing."""
        return {"prefill_s": 0.0, "decode_s": 0.0, "steps": 0,
                "prefill_tokens": 0, "decode_tokens": 0,
                "prefill_dispatches": 0, "decode_dispatches": 0,
                "host_bytes_prefill": 0, "host_bytes_decode": 0,
                # paged-mode extras (zero in contiguous mode); page-table
                # uploads have their own byte counter
                "host_bytes_page_tables": 0, "prefill_chunks": 0,
                "prefix_hit_tokens": 0, "cow_copies": 0,
                "pages_in_use": 0, "pages_peak": 0}

    # -- observability ------------------------------------------------------
    def set_obs_labels(self, labels: Dict[str, str]) -> None:
        """(Re)bind this server's metric children. Standalone servers carry
        ``{"replica": "solo"}``; the router rebinds each to its index."""
        self.obs_labels = dict(labels)
        r = self.registry
        rep = self.obs_labels.get("replica", "solo")
        lab = ("replica", "phase")
        self._m_dispatch = {
            p: r.counter("serve_dispatches_total",
                         "device dispatches", lab).labels(replica=rep,
                                                          phase=p)
            for p in ("prefill", "decode")}
        self._m_tokens = {
            p: r.counter("serve_tokens_total",
                         "tokens prefilled / decoded", lab).labels(
                             replica=rep, phase=p)
            for p in ("prefill", "decode")}
        self._m_dispatch_s = {
            p: r.histogram("serve_dispatch_seconds",
                           "wall time per device dispatch", lab).labels(
                               replica=rep, phase=p)
            for p in ("prefill", "decode")}
        self._m_host_bytes = {
            p: r.counter("serve_host_bytes_total",
                         "bytes crossing the device->host boundary", lab)
            .labels(replica=rep, phase=p)
            for p in ("prefill", "decode", "page_tables")}
        self._m_e2e = r.histogram(
            "serve_request_e2e_seconds", "submit -> done", ("replica",)
        ).labels(replica=rep)
        self._m_ttft = r.histogram(
            "serve_request_ttft_seconds", "submit -> first token",
            ("replica",)).labels(replica=rep)
        self._m_pages = r.gauge(
            "serve_pages_in_use", "page-pool pages currently referenced",
            ("replica",)).labels(replica=rep)
        self._m_prefix_hits = r.counter(
            "serve_prefix_hit_tokens_total",
            "prompt tokens skipped via prefix sharing", ("replica",)
        ).labels(replica=rep)
        self._m_cow = r.counter(
            "serve_cow_copies_total", "copy-on-write page copies",
            ("replica",)).labels(replica=rep)
        # the SLO-facing latencies over the last `obs_window_s` seconds,
        # labelled by replica AND tier so a mixed fleet reads per-tier
        # percentiles off one family
        wlab = ("replica", "tier")
        self._w_ttft = r.windowed_histogram(
            "serve_ttft_window_seconds",
            "submit -> first token, sliding window", wlab,
            window_s=self.obs_window_s, clock=self._clock
        ).labels(replica=rep, tier=self.tier)
        self._w_itl = r.windowed_histogram(
            "serve_itl_window_seconds",
            "per-token inter-token latency, sliding window", wlab,
            window_s=self.obs_window_s, clock=self._clock
        ).labels(replica=rep, tier=self.tier)

    @property
    def events(self) -> List[Tuple]:
        """Dispatch interleaving, oldest first, reconstructed from the span
        ring: ``("prefill_chunk", rid, start, end)`` and ``("decode",
        (rids...))`` tuples. Bounded by the tracer's capacity."""
        out: List[Tuple] = []
        for s in self.tracer.spans:
            if s.name == "prefill_chunk":
                out.append(("prefill_chunk", s.attrs["rid_int"],
                            s.attrs["start"], s.attrs["end"]))
            elif s.name == "decode" and "rids" in s.attrs:
                out.append(("decode", tuple(s.attrs["rids"])))
        return out

    def _end_req_span(self, rid: int, **attrs) -> None:
        span = self._req_spans.pop(rid, None)
        if span is not None:
            self.tracer.end(span, **attrs)

    # -- GEMM scope and run-ready params ------------------------------------
    def _new_cache(self, batch: int) -> dict:
        """A zero contiguous cache of ``batch`` rows; under a mesh this
        rank's piece of it (``dist.sharding.serving_cache_specs``: the K/V
        heads, the SSM states' local d_inner or heads)."""
        cache = self.model.init_cache(batch, self.max_len)
        if self.mesh is None:
            return cache
        return sharding.shard_tree(
            cache, sharding.serving_cache_specs(cache, self.mesh,
                                                self.model.cfg, batch=batch),
            self.mesh)

    def _gemm_scope(self):
        stack = contextlib.ExitStack()
        if self.mesh is not None:
            stack.enter_context(dctx.mesh_context(self.mesh))
        if self._gemm_cfg is not None:
            stack.enter_context(use_gemm(self._gemm_cfg))
        stack.enter_context(compat.use_derived(self._derived))
        stack.enter_context(torch.no_grad())
        return stack

    def _params_for(self, params):
        """The run-ready tree. With a ``prepared`` artifact: its params, its
        y deltas and carry tables seeded into the server's memo once
        (``params`` is not read); under a mesh, this rank's cut of the
        artifact. Else, built once per distinct params object: int8 ``q``
        entries attached when quantized (the whole weights quantized, then
        cut), under a mesh this rank's pieces, and for the FFIP kernels the
        y-deltas (and their carry tables) of every weight the forward will
        hand them, computed now into the server's memo (it keys on
        storage, so the per-layer views the forward slices later hit
        it)."""
        if self.prepared is not None:
            if self._prepared_src is not self.prepared:
                self._derived.clear()
                pm = self.prepared
                if self.mesh is not None:
                    pm = self._local_prepared = pm.shard(
                        self._specs(pm.params), self.mesh)
                pm.seed_into(self._derived)
                self._prepared_params = pm.params
                self._prepared_src = self.prepared
            return self._prepared_params
        if self._gemm_cfg is None and self.mesh is None:
            return params
        if self._prepared_src is not params:
            self._derived.clear()
            with self._gemm_scope():
                p = (attach_quantized_weights(params) if self.quantized
                     else params)
                if self.mesh is not None:
                    p = sharding.shard_tree(p, self._specs(p), self.mesh)
                cfg = self._gemm_cfg
                if cfg is not None and cfg.algo == "ffip" and \
                        cfg.impl == "cuda":
                    self._warm_y(p)
            self._prepared_params, self._prepared_src = p, params
        return self._prepared_params

    def _specs(self, params):
        return sharding.serving_specs(params, self.mesh, self.model.cfg,
                                      self.moe_partition)

    def _warm_y(self, p) -> None:
        for w in _ffip_weights(p, self.quantized):
            for view in (w if w.dim() == 3 else [w]):
                ffip_gemm.prepare(view)
        if self.model.cfg.tie_embeddings:
            ffip_gemm.prepare(p["embed"]["table"].T)

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
        if self.paged:
            # worst-case pages beyond the whole pool can never be admitted,
            # however many slots drain
            pages = -(-rows // self.page_size)
            if pages > self.num_pages:
                raise AdmissionImpossibleError(
                    f"request {req.rid}: needs {pages} pages worst-case "
                    f"({rows} rows / page_size {self.page_size}) but the "
                    f"pool holds only {self.num_pages}")
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
            self.tracer.event("request", rid=str(req.rid), cached=True)
            self._cached_hits.append(req)
            return
        req.out_tokens = []
        req.itl_s = []
        if self.trace_requests and req.rid not in self._req_spans:
            self._req_spans[req.rid] = self.tracer.start(
                "request", rid=str(req.rid), prompt=len(req.prompt),
                max_new_tokens=req.max_new_tokens)
        self._queue.append(req)

    def has_queued(self) -> bool:
        return bool(self._queue)

    def _finish(self, req: Request):
        req.t_done = self._clock()
        self._m_e2e.observe(req.t_done - req.t_submit)
        if req.t_first:
            self._m_ttft.observe(req.t_first - req.t_submit)
        self._end_req_span(req.rid, tokens=len(req.out_tokens))
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
        """Drain the completion list (the router's per-tick collection;
        :meth:`run_until_drained` keeps accumulating instead)."""
        done, self._completed = self._completed, []
        return done

    def abort(self, rid: int) -> bool:
        """Remove a request wherever it lives (queue, slot, or the result
        cache), releasing what it held. A paged request's pages are
        decref'd and its admission reservation returned; prefix pages are
        published only up to the rows actually computed, so an aborted
        prefill never poisons the prefix index. Duplicates waiting on it are
        queued in its place. Returns True if anything was removed."""
        found = self._results.pop(rid, None) is not None
        for i, r in enumerate(self._queue):
            if r.rid == rid:
                del self._queue[i]
                found = True
                break
        else:
            for slot in self.slots:
                if slot.req is not None and slot.req.rid == rid:
                    if slot.seq is not None:
                        self._release_seq(slot, upto=slot.seq.filled)
                    slot.req = None
                    slot.pos = 0
                    slot.remaining = 0
                    found = True
                    break
        for w in self._dup_waiters.pop(rid, []):
            self._queue.appendleft(w)
        if found:
            self._end_req_span(rid, aborted=True)
        return found

    # -- router-facing load/health introspection ---------------------------
    def free_slots(self) -> int:
        return sum(1 for s in self.slots if s.req is None)

    def outstanding_rows(self) -> int:
        """Worst-case cache rows committed to requests this server holds
        (slots + internal queue): the router's least-loaded metric."""
        rows = 0
        for s in self.slots:
            if s.req is not None:
                rows += self.cache_rows(len(s.req.prompt),
                                        s.req.max_new_tokens)
        for r in self._queue:
            rows += self.cache_rows(len(r.prompt), r.max_new_tokens)
        return rows

    def page_headroom(self) -> Optional[int]:
        """Upper bound on pages a NEW request could still claim: free pages
        minus outstanding reservations, plus prefix-index entries that
        admission may evict. None in contiguous mode."""
        if not self.paged:
            return None
        return self.alloc.free_count - self._reserved + len(self.prefix)

    def request_phase(self, rid: int) -> Optional[str]:
        """'queued' | 'prefilling' | 'decoding' for an inflight rid, None if
        unknown. Contiguous prefill is atomic inside a step, so contiguous
        requests are never seen 'prefilling'."""
        for r in self._queue:
            if r.rid == rid:
                return "queued"
        for s in self.slots:
            if s.req is not None and s.req.rid == rid:
                if s.seq is not None and s.seq.compute_next < s.seq.n:
                    return "prefilling"
                return "decoding"
        return None

    def _place(self, slot_i: int, req: Request, first: int):
        req.out_tokens.append(first)
        req.t_first = self._clock()
        self._w_ttft.observe(req.t_first - req.t_submit)
        slot = self.slots[slot_i]
        if req.max_new_tokens <= 1 or first == req.eos_id:
            self._finish(req)          # done at prefill: slot stays free
            if slot.seq is not None:
                self._release_seq(slot)
            slot.req = None
            return
        slot.req = req
        slot.pos = len(req.prompt)
        slot.remaining = req.max_new_tokens - 1

    def _admit(self, params):
        if self.paged:
            self._admit_paged()
            return
        while self._queue:
            free = [i for i, s in enumerate(self.slots) if s.req is None]
            if not free:
                return
            if self._bucketed:
                self._admit_bucket(params, free)
            else:
                self._admit_one(params, free[0])

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
        span = self.tracer.start("prefill", bucket=bucket,
                                 rids=[r.rid for r in batch])
        t0 = self._clock()
        dev = self.device
        with self._gemm_scope():
            self.cache, first = self.model.prefill_sample(
                params, torch.from_numpy(tokens).to(dev), self.cache,
                torch.from_numpy(lengths).to(dev),
                torch.from_numpy(mask).to(dev))
        first_h = first.cpu().numpy()
        dt = self._clock() - t0
        self.tracer.end(span)
        self.stats["prefill_s"] += dt
        self.stats["prefill_dispatches"] += 1
        self.stats["host_bytes_prefill"] += int(first_h.nbytes)
        self._m_dispatch["prefill"].inc()
        self._m_dispatch_s["prefill"].observe(dt)
        self._m_tokens["prefill"].inc(sum(len(r.prompt) for r in batch))
        self._m_host_bytes["prefill"].inc(int(first_h.nbytes))
        for slot_i, req in zip(free, batch):
            self._place(slot_i, req, int(first_h[slot_i]))

    def _admit_one(self, params, slot_i: int):
        """The per-slot scatter prefill: one prompt through a batch-1
        forward into a fresh cache, copied into slot ``slot_i`` along each
        leaf's batch axis; the argmax stays on the device."""
        req = self._queue.popleft()
        dev = self.device
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=dev)[None]
        span = self.tracer.start("prefill", rid=str(req.rid),
                                 tokens=len(req.prompt))
        t0 = self._clock()
        with self._gemm_scope():
            one, logits = self.model.prefill(params, tokens,
                                             self._new_cache(1))
            _scatter_slot(self.cache, one, self._batch_axes, slot_i)
            first = torch.argmax(logits[0]).to(torch.int32)
        first_h = int(first)
        dt = self._clock() - t0
        self.tracer.end(span)
        self.stats["prefill_s"] += dt
        self.stats["prefill_tokens"] += len(req.prompt)
        self.stats["prefill_dispatches"] += 1
        self.stats["host_bytes_prefill"] += 4
        self._m_dispatch["prefill"].inc()
        self._m_dispatch_s["prefill"].observe(dt)
        self._m_tokens["prefill"].inc(len(req.prompt))
        self._m_host_bytes["prefill"].inc(4)
        self._place(slot_i, req, first_h)

    # -- paged mode --------------------------------------------------------
    def _admit_paged(self):
        """Admission is host bookkeeping only: the prompt runs later, one
        page-aligned chunk per :meth:`step`, via :meth:`_prefill_tick`.
        Strict FIFO: a head-of-queue request that cannot reserve its
        worst-case pages blocks the queue until running requests release
        pages."""
        while self._queue:
            free = [i for i, s in enumerate(self.slots) if s.req is None]
            if not free:
                return
            if not self._try_admit_paged(free[0], self._queue[0]):
                if (all(s.req is None for s in self.slots)
                        and not len(self.prefix)):
                    req = self._queue[0]
                    raise RuntimeError(
                        f"request {req.rid} needs more pages than the pool "
                        f"holds ({self.alloc.num_pages}) even with every "
                        f"slot idle: raise num_pages or lower "
                        f"max_new_tokens")
                return
            self._queue.popleft()

    def _try_admit_paged(self, slot_i: int, req: Request) -> bool:
        """Plan a request: attach shared prefix pages from the index
        (refcounted), then reserve worst-case fresh pages, evicting LRU index
        entries under pressure. All or nothing: on failure every attached
        page is released and the queue head stays put."""
        ps = self.page_size
        n = len(req.prompt)
        pages_needed = -(-self.cache_rows(n, req.max_new_tokens) // ps)
        keys = page_keys(req.prompt, ps) if self.prefix_sharing else []
        pkey = partial_key(req.prompt, ps) if self.prefix_sharing else None
        attached: List[int] = []
        hit = 0
        shared_tail = False
        for k in keys:                   # chained keys: the walk stops at
            page = self.prefix.get(k)    # the first miss
            if page is None:
                break
            self.alloc.incref(page)
            attached.append(page)
            hit += ps
        if pkey is not None and len(attached) == len(keys):
            page = self.prefix.get(pkey)
            if page is not None:         # whole-prompt match incl. tail
                self.alloc.incref(page)
                attached.append(page)
                shared_tail = True
                hit = n
        # worst-case fresh pages: everything not attached, plus one COW
        # copy when the shared tail page will be decoded into
        worst = (pages_needed - len(attached)
                 + (1 if shared_tail and req.max_new_tokens > 1 else 0))
        while (self.alloc.free_count - self._reserved < worst
               and len(self.prefix)):
            self.prefix.evict_lru(1)
        if self.alloc.free_count - self._reserved < worst:
            for p in attached:
                self.alloc.decref(p)
            return False
        self._reserved += worst
        self.stats["prefix_hit_tokens"] += hit
        if hit:
            self._m_prefix_hits.inc(hit)
        seq = _PagedSeq(
            n=n, pages=attached, keys=keys, pkey=pkey, filled=hit,
            # a fully shared prompt still recomputes its LAST token (the
            # first sample needs its hidden state) and writes nothing
            compute_next=min(hit, n - 1), shared_tail=shared_tail,
            reserve=worst, registered=min(len(attached), len(keys)))
        slot = self.slots[slot_i]
        slot.req = req
        slot.seq = seq
        slot.pos = 0
        slot.remaining = 0               # set by _place on the final chunk
        return True

    def _alloc_page(self, seq: _PagedSeq) -> int:
        page = self.alloc.alloc()
        assert seq.reserve > 0, "page allocated beyond admission reservation"
        seq.reserve -= 1
        self._reserved -= 1
        return page

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy pool page ``src`` to ``dst`` in every layer's K and V."""
        for group in self.cache.values():
            for leaf in group.values():
                leaf[:, dst] = leaf[:, src]

    def _ensure_pages(self, slot: _Slot, first_row: int, end_row: int):
        """Make rows [first_row, end_row) WRITABLE: allocate missing pages
        and copy on write any shared page in the range (refcount > 1: the
        prefix index or another sequence still reads it)."""
        if first_row >= end_row:
            return
        seq = slot.seq
        ps = self.page_size
        for li in range(first_row // ps, -(-end_row // ps)):
            if li >= len(seq.pages):
                seq.pages.append(self._alloc_page(seq))
            elif self.alloc.refcount(seq.pages[li]) > 1:
                old = seq.pages[li]
                new = self._alloc_page(seq)
                self._copy_page(old, new)
                self.alloc.decref(old)
                seq.pages[li] = new
                self.stats["cow_copies"] += 1
                self._m_cow.inc()

    def _register_prefix(self, seq: _PagedSeq, upto_rows: int):
        """Publish every FULL prompt page whose rows are all filled."""
        if not self.prefix_sharing:
            return
        while (seq.registered < len(seq.keys)
               and (seq.registered + 1) * self.page_size <= upto_rows):
            self.prefix.register(seq.keys[seq.registered],
                                 seq.pages[seq.registered])
            seq.registered += 1

    def _release_seq(self, slot: _Slot, *, upto: Optional[int] = None):
        """Drop a finished request's page references. Prompt pages stay
        resident through the prefix index (which holds its own reference)
        until LRU eviction; the terminal partial page is published here,
        keyed by the whole prompt, so an identical prompt skips prefill.
        ``upto`` caps publication at the prompt rows actually computed (an
        aborted prefill publishes only its finished pages)."""
        seq = slot.seq
        upto = seq.n if upto is None else min(upto, seq.n)
        self._register_prefix(seq, upto)
        tail_li = seq.n // self.page_size
        if (self.prefix_sharing and seq.pkey is not None and upto >= seq.n
                and len(seq.pages) > tail_li):
            self.prefix.register(seq.pkey, seq.pages[tail_li])
        for p in seq.pages:
            self.alloc.decref(p)
        self._reserved -= seq.reserve
        seq.reserve = 0
        slot.seq = None

    def _page_table(self, rows: int, seqs) -> Tensor:
        """Zero-filled (rows, max_pages) int32 table on the device, its
        upload counted in ``host_bytes_page_tables``: every entry is in
        range, and the unused ones are masked by length."""
        pt = np.zeros((rows, self.max_pages), np.int32)
        for i, seq in seqs:
            pt[i, :len(seq.pages)] = seq.pages
        self.stats["host_bytes_page_tables"] += int(pt.nbytes)
        self._m_host_bytes["page_tables"].inc(int(pt.nbytes))
        return torch.from_numpy(pt).to(self.device)

    def _prefill_tick(self, params) -> int:
        """Dispatch at most ONE page-aligned prefill chunk per mid-prefill
        slot, then return: the decode dispatch runs next, so a long prompt
        stalls active slots for one chunk at most. Returns the number of
        chunks dispatched."""
        work = 0
        chunk = self.prefill_chunk
        for slot_i, slot in enumerate(self.slots):
            seq = slot.seq
            if slot.req is None or seq is None or seq.compute_next >= seq.n:
                continue
            start = seq.compute_next
            end = min(seq.n, (start // chunk + 1) * chunk)
            self._ensure_pages(slot, max(start, seq.filled), end)
            tokens = np.zeros((1, chunk), np.int64)
            tokens[0, :end - start] = slot.req.prompt[start:end]
            span = self.tracer.start("prefill_chunk", rid=str(slot.req.rid),
                                     rid_int=slot.req.rid, start=start,
                                     end=end)
            t0 = self._clock()
            pt = self._page_table(1, [(0, seq)])
            with self._gemm_scope():
                self.cache, tok = self.model.prefill_chunk_paged(
                    params, torch.from_numpy(tokens).to(self.device),
                    self.cache, pt, start, end - start, seq.filled,
                    paged_impl=self.paged_attention)
            last_chunk = end >= seq.n
            if last_chunk:                 # the token means something here
                first = int(tok)
                self.stats["host_bytes_prefill"] += 4
                self._m_host_bytes["prefill"].inc(4)
            dt = self._clock() - t0
            self.tracer.end(span)
            self.stats["prefill_s"] += dt
            self.stats["prefill_tokens"] += end - start
            self.stats["prefill_dispatches"] += 1
            self.stats["prefill_chunks"] += 1
            self._m_dispatch["prefill"].inc()
            self._m_dispatch_s["prefill"].observe(dt)
            self._m_tokens["prefill"].inc(end - start)
            seq.compute_next = end
            seq.filled = max(seq.filled, end)
            self._register_prefix(seq, seq.filled)
            work += 1
            if last_chunk:
                self._place(slot_i, slot.req, first)
        return work

    def _refresh_page_stats(self):
        self.stats["pages_in_use"] = self.alloc.in_use
        self.stats["pages_peak"] = self.alloc.peak_in_use
        self._m_pages.set(self.alloc.in_use)

    # -- decode ------------------------------------------------------------
    def step(self, params) -> int:
        """Admit what fits, then (paged) at most one prefill chunk per
        mid-prefill slot, then one fused decode dispatch (``decode_chunk``
        lockstep steps) over all active slots. Returns the number of active
        decode slots plus prefill chunks dispatched."""
        if self._cached_hits:
            self._completed.extend(self._cached_hits)
            self._cached_hits.clear()
        params = self._params_for(params)
        self._admit(params)
        prefill_work = self._prefill_tick(params) if self.paged else 0
        # mid-prefill paged slots hold remaining == 0 and sit out decode
        active = [i for i, s in enumerate(self.slots)
                  if s.req is not None and s.remaining > 0]
        if not active:
            if self.paged:
                self._refresh_page_stats()
            return prefill_work
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
        # frozen slots rewrite their own row with unchanged values
        # (contiguous) or write nothing (paged: pool rows may be shared).
        dev = self.device
        span = self.tracer.start(
            "decode", rids=[self.slots[i].req.rid for i in active],
            chunk=self.decode_chunk)
        pt = None
        if self.paged:
            for i in active:
                slot = self.slots[i]
                self._ensure_pages(slot, slot.pos,
                                   slot.pos + min(self.decode_chunk,
                                                  slot.remaining))
        t0 = self._clock()
        if self.paged:
            pt = self._page_table(self.b, [(i, self.slots[i].seq)
                                           for i in active])
        with self._gemm_scope():
            self.cache, toks = self.model.sample_steps(
                params, torch.from_numpy(last).to(dev), self.cache,
                torch.from_numpy(pos).to(dev), torch.from_numpy(live).to(dev),
                torch.from_numpy(rem).to(dev), torch.from_numpy(eos).to(dev),
                steps=self.decode_chunk, page_table=pt,
                paged_impl=self.paged_attention if self.paged else "gather")
        toks_h = toks.cpu().numpy().astype(np.int32)     # (chunk, B)
        dt = self._clock() - t0
        self.tracer.end(span)
        self.stats["decode_s"] += dt
        self.stats["decode_dispatches"] += 1
        self.stats["host_bytes_decode"] += int(toks_h.nbytes)
        self._m_dispatch["decode"].inc()
        self._m_dispatch_s["decode"].observe(dt)
        self._m_host_bytes["decode"].inc(int(toks_h.nbytes))
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
                self._w_itl.observe(step_dt)
                if slot.req.itl_s is not None:
                    slot.req.itl_s.append(step_dt)
                slot.pos += 1
                slot.remaining -= 1
                emitted += 1
                if slot.remaining <= 0 or nxt == slot.req.eos_id:
                    self._finish(slot.req)
                    if slot.seq is not None:
                        self._release_seq(slot)
                    slot.req = None
            if emitted:
                self.stats["steps"] += 1
                self.stats["decode_tokens"] += emitted
                self._m_tokens["decode"].inc(emitted)
        if self.paged:
            self._refresh_page_stats()
        return len(active) + prefill_work

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
                    phase = self.request_phase(s.req.rid) or "decoding"
                    stuck[s.req.rid] = (f"slot {i} ({phase}): pos={s.pos} "
                                        f"remaining={s.remaining}")
            if stuck:
                raise ServeStallError(
                    f"run_until_drained hit max_steps={max_steps} with "
                    f"{len(stuck)} request(s) still live", stuck=stuck)
        return self._completed
