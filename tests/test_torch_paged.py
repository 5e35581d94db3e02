"""The port's paged serving against the reference's, module by module and as a
whole, on the same numpy inputs (JAX on the CPU, Pallas in interpret mode).

* ``serve/paged.py``: the allocator, chained keys and prefix index keep the
  reference tests' invariants, and the keys are byte-equal to the
  reference's.
* ``models/attention.py``: ``_paged_write`` / ``_paged_view`` bit for bit,
  dropped rows included.
* K5: the plain version against ``flash_attention_paged(interpret=True)``
  at rtol = atol = 2e-3, the bar of tests/test_flash_attention.py; rows with
  no valid key exactly 0. v is drawn in [-0.25, 0.25), so one bf16 rounding
  of an output (at most 2**-10 there) stays inside that bar.
* ``Model.prefill_chunk_paged`` / ``sample_step(page_table=...)``: pools and
  tokens against the reference's.
* ``BatchServer(paged=True)``: tokens identical to the reference's paged
  server (``gemm_impl="pallas"``) on the workload of
  tests/test_serve_paged.py, float and int8 x decode_chunk 1 and 4 with
  gather, float at 4 with flash; identical to the port's own contiguous
  server; the page counters equal the reference's. Then the rest of
  tests/test_serve_paged.py against the port's contiguous server: chunked
  prefill, prefix sharing and COW, interleaving, capacity, abort and churn.

attention_impl is "naive" as in the reference tests, so the contiguous
oracle and the paged gather path run the same plain attention.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.kernels.flash_attention import flash_attention_paged as j_paged
from repro.models import attention as JA
from repro.models.model import build_model as j_build
from repro.serve import paged as jpaged
from repro.serve.batcher import BatchServer as JServer
from repro.serve.batcher import Request as JRequest
from repro_torch import bridge, configs
from repro_torch.kernels import compat
from repro_torch.kernels.flash_paged import (MAX_SPLITS, SPLIT_KEYS,
                                             flash_attention_paged,
                                             flash_attention_paged_plain,
                                             split_plan)
from repro_torch.models import attention as A
from repro_torch.models.model import Model
from repro_torch.serve.batcher import BatchServer, Request
from repro_torch.serve.lifecycle import AdmissionImpossibleError
from repro_torch.serve.paged import (PageAllocator, PrefixIndex, page_keys,
                                     partial_key)

MAX_LEN = 48
PS = 8


# -- host-side bookkeeping ----------------------------------------------------

def test_page_allocator_invariants_under_churn():
    rng = np.random.default_rng(0)
    a = PageAllocator(32)
    refs = {}                                    # page -> expected refcount
    for _ in range(2000):
        op = int(rng.integers(0, 3))
        if op == 0 and a.free_count:
            p = a.alloc()
            assert p not in refs, "alloc returned a still-referenced page"
            refs[p] = 1
        elif op == 1 and refs:
            p = int(rng.choice(list(refs)))
            a.incref(p)
            refs[p] += 1
        elif op == 2 and refs:
            p = int(rng.choice(list(refs)))
            freed = a.decref(p)
            refs[p] -= 1
            assert freed == (refs[p] == 0)
            if refs[p] == 0:
                del refs[p]
        assert a.free_count + a.in_use == a.num_pages
        assert a.in_use == len(refs)
        for p, r in refs.items():
            assert a.refcount(p) == r
    while a.free_count:
        refs[a.alloc()] = 1
    assert a.peak_in_use == a.num_pages
    with pytest.raises(RuntimeError):
        a.alloc()


def test_prefix_keys_chained():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1000, size=(25,))
    b = a.copy()
    b[18] += 1                                   # diverge inside page 2
    ka, kb = page_keys(a, 8), page_keys(b, 8)
    assert len(ka) == 3
    assert ka[:2] == kb[:2], "identical prefix pages must share keys"
    assert ka[2] != kb[2], "divergent page must differ"
    assert partial_key(a, 8) != partial_key(b, 8)
    assert partial_key(a[:24], 8) is None, "aligned prompt has no tail"
    assert partial_key(a[:20], 8) != partial_key(a[:21], 8)
    d = a.copy()
    d[24] += 1
    assert partial_key(a, 8) != partial_key(d, 8)


@pytest.mark.parametrize("n,ps", [(1, 8), (16, 8), (25, 8), (44, 4),
                                  (130, 16)])
def test_prefix_keys_byte_equal_to_reference(n, ps):
    prompt = np.random.default_rng(n).integers(0, 122753, size=(n,))
    assert page_keys(prompt, ps) == jpaged.page_keys(prompt, ps)
    assert partial_key(prompt, ps) == jpaged.partial_key(prompt, ps)


def test_prefix_index_holds_refs_and_evicts_lru():
    a = PageAllocator(8)
    idx = PrefixIndex(a)
    p0, p1 = a.alloc(), a.alloc()
    idx.register(b"k0", p0)
    idx.register(b"k1", p1)
    assert a.refcount(p0) == 2, "index holds its own reference"
    idx.register(b"k0", p0)                      # idempotent
    assert a.refcount(p0) == 2
    a.decref(p0)                                 # owner finishes
    assert idx.get(b"k0") == p0, "page outlives its owner via the index"
    assert a.refcount(p0) == 1
    assert idx.evict_lru(1) == 0                 # k1's owner still holds it
    assert idx.get(b"k1") is None
    assert a.refcount(p1) == 1
    assert idx.evict_lru(1) == 1                 # k0 unreferenced -> freed
    assert len(idx) == 0
    assert a.in_use == 1


# -- paged cache ops ----------------------------------------------------------

def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x).astype(dtype)
    return j, bridge.params_from_numpy(np.asarray(j))


# sequence 1 shares page 0 with sequence 0 but is masked out in the
# (B,)-mask case: its dropped rows must not touch the shared page
_TABLE = np.asarray([[0, 1, 2], [0, 4, 5], [6, 7, 8]], np.int32)
WRITE_CASES = {
    "vector-pos": (np.asarray([0, 3, 9]), None),
    "scalar-pos": (2, None),
    "slot-mask": (np.asarray([0, 3, 9]), np.asarray([True, False, True])),
    "row-mask": (np.asarray([1, 3, 9]),
                 np.asarray([[1, 1, 0, 1, 0], [0, 0, 0, 0, 0],
                             [1, 0, 1, 1, 1]], bool)),
    "all-dropped": (np.asarray([0, 3, 9]), np.zeros((3,), bool)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_paged_write_matches_reference(case, dtype):
    pos, mask = WRITE_CASES[case]
    if case in ("vector-pos", "scalar-pos"):
        table = _TABLE.copy()
        table[1, 0] = 3          # every kept row has its own pool row
    else:
        table = _TABLE
    rng = np.random.default_rng(7)
    pool = rng.standard_normal((10, 4, 2, 3), np.float32)
    new = rng.standard_normal((3, 5, 2, 3), np.float32)
    jpool, tpool = _pair(pool, dtype)
    jnew, tnew = _pair(new, dtype)
    jpos = jnp.asarray(pos, jnp.int32)
    tpos = torch.as_tensor(pos)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = JA._paged_write(jpool, jnew, jnp.asarray(table), jpos, jm)
    got = A._paged_write(tpool, tnew, torch.from_numpy(table), tpos, tm)
    assert got is tpool, "the port writes the pool in place"
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # rows past the table (sequence 2 at 12, 13) went nowhere, and a
    # masked-out or fully dropped write left the pool as it was
    if case == "all-dropped":
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(jpool.astype(jnp.float32)))


def test_paged_view_matches_reference():
    rng = np.random.default_rng(8)
    pool = rng.standard_normal((10, 4, 2, 3), np.float32)
    want = JA._paged_view(jnp.asarray(pool), jnp.asarray(_TABLE))
    got = A._paged_view(torch.from_numpy(pool), torch.from_numpy(_TABLE))
    assert got.shape == (3, 12, 2, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- K5: the plain version against the Pallas kernel --------------------------

def _k5_inputs(b, h, kv, sq, d, dv, n_pages, ps, max_pages, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d), np.float32)
    kp = rng.standard_normal((n_pages, ps, kv, d), np.float32)
    vp = rng.uniform(-0.25, 0.25, (n_pages, ps, kv, dv)).astype(np.float32)
    # physical page order != logical order
    pt = np.stack([rng.permutation(n_pages)[:max_pages] for _ in range(b)])
    return q, kp, vp, pt.astype(np.int32)


def _k5_check(q, kp, vp, pt, lengths, q_start, window, dtype, scale=None):
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(kp, dtype)
    jv, tv = _pair(vp, dtype)
    want = j_paged(jq, jk, jv, jnp.asarray(pt), jnp.asarray(lengths),
                   jnp.asarray(q_start), window, scale=scale, interpret=True)
    got = flash_attention_paged(tq, tk, tv, torch.from_numpy(pt),
                                torch.from_numpy(lengths),
                                torch.from_numpy(q_start), window,
                                scale=scale)
    assert got.dtype == tq.dtype and got.shape == tuple(want.shape)
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               rtol=2e-3, atol=2e-3)
    return got, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("sq", [1, 4, 8])
@pytest.mark.parametrize("window", [0, 11])
def test_k5_plain_matches_pallas(dtype, h, kv, sq, window):
    b, d, ps, mp = 3, 16, 8, 4
    q, kp, vp, pt = _k5_inputs(b, h, kv, sq, d, d, 12, ps, mp, seed=sq + h)
    lengths = np.asarray([0, 13, ps * mp], np.int32)    # empty, ragged, full
    q_start = np.maximum(lengths - sq, 0).astype(np.int32)
    got, want = _k5_check(q, kp, vp, pt, lengths, q_start, window, dtype)
    assert np.count_nonzero(got[0]) == 0, "no valid key -> exactly 0"
    assert np.count_nonzero(want[0]) == 0
    assert np.count_nonzero(got[1:]) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_plain_dv_and_scale(dtype):
    """The absorbed-MLA shape: one kv head, dv != d, a scale override."""
    b, h, d, dv, ps, mp = 2, 4, 40, 32, 4, 4
    q, kp, vp, pt = _k5_inputs(b, h, 1, 2, d, dv, 8, ps, mp, seed=3)
    lengths = np.asarray([13, 9], np.int32)
    _k5_check(q, kp, vp, pt, lengths, lengths - 2, 0, dtype,
              scale=1.0 / 48 ** 0.5)


def test_k5_plain_out_windowed_rows_exact_zero():
    """A chunk whose later rows out-window every valid key gives exact
    zeros there, as the reference's (tests/test_flash_attention.py)."""
    q, kp, vp, pt = _k5_inputs(2, 2, 2, 8, 32, 32, 8, 8, 4, seed=2)
    lengths = np.asarray([16, 0], np.int32)
    q_start = np.asarray([30, 0], np.int32)
    got, _ = _k5_check(q, kp, vp, pt, lengths, q_start, 16, "float32")
    assert np.all(got[0, :, 1:] == 0.0)
    assert np.all(got[1] == 0.0)


def test_k5_cpu_path_is_the_plain_version():
    q, kp, vp, pt = _k5_inputs(2, 4, 2, 3, 16, 16, 8, 4, 4, seed=5)
    args = [torch.from_numpy(x) for x in (q, kp, vp, pt)]
    lengths, q_start = torch.tensor([9, 16]), torch.tensor([6, 13])
    before = compat.launch_counts()["flash_paged"]
    got = flash_attention_paged(*args, lengths, q_start, 0)
    assert torch.equal(got, flash_attention_paged_plain(*args, lengths,
                                                        q_start, 0))
    assert compat.launch_counts()["flash_paged"] == before


@pytest.mark.parametrize("max_pages,ps", [(1, 1), (16, 16), (32, 16),
                                          (5, 13), (64, 16), (300, 16)])
def test_k5_split_plan_depends_on_key_capacity_only(max_pages, ps):
    """K5's split-KV plan: splits of a multiple of 64 keys counted from key
    0, at most MAX_SPLITS of them (one thread-block cluster), covering
    max_pages * ps keys exactly. It takes the pool's key capacity alone (no
    B, Sq or lengths), so every call on one pool, whatever its batch and
    chunk, launches the same splits."""
    keys = max_pages * ps
    kps, n_splits = split_plan(keys)
    assert kps % SPLIT_KEYS == 0 and kps % 16 == 0
    assert 1 <= n_splits <= MAX_SPLITS
    assert (n_splits - 1) * kps < keys <= n_splits * kps
    if keys <= SPLIT_KEYS * MAX_SPLITS:
        assert kps == SPLIT_KEYS


# -- the model over page pools ------------------------------------------------

_SETUP = {}


def _setup():
    """(reference model, its params, the port's model, the same params)."""
    if not _SETUP:
        jc = dataclasses.replace(jcfg.smoke_config(jcfg.get_config(
            "minicpm-2b")), attention_impl="naive")
        jm = j_build(jc)
        jp = jm.init(jax.random.PRNGKey(0))
        cfg = dataclasses.replace(configs.smoke_config(configs.get_config(
            "minicpm-2b")), attention_impl="naive")
        tm = Model(cfg, device="cpu")
        tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
        _SETUP.update(jm=jm, jp=jp, tm=tm, tp=tp, cfg=cfg)
    return _SETUP


@pytest.mark.parametrize("impl", ["gather", "flash"])
def test_model_paged_chunks_and_step_match_reference(impl):
    """Two prefill chunks of one prompt, then a decode step of two
    sequences with the second's writes masked off: the same pools (f32,
    2e-5) and tokens as the reference's."""
    s = _setup()
    jm, jp, tm, tp = s["jm"], s["jp"], s["tm"], s["tp"]
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, s["cfg"].vocab, size=(21,))
    jc, tc = jm.init_paged_cache(8, PS), tm.init_paged_cache(8, PS)
    table = np.asarray([[2, 5, 7, 0, 0, 0]], np.int32)
    toks = []
    for off, chunk in ((0, prompt[:16]), (16, prompt[16:])):
        pad = np.zeros((1, 16), np.int64)
        pad[0, :len(chunk)] = chunk
        jc, jt = jm.prefill_chunk_paged(
            jp, jnp.asarray(pad, jnp.int32), jc, jnp.asarray(table),
            jnp.asarray(off, jnp.int32), jnp.asarray(len(chunk), jnp.int32),
            jnp.asarray(off, jnp.int32), paged_impl=impl)
        tc, tt = tm.prefill_chunk_paged(
            tp, torch.from_numpy(pad), tc, torch.from_numpy(table), off,
            len(chunk), off, paged_impl=impl)
        toks.append((int(jt), int(tt)))
    assert toks[-1][0] == toks[-1][1]
    table2 = np.asarray([[2, 5, 7, 0, 0, 0], [2, 1, 0, 0, 0, 0]], np.int32)
    tok = np.asarray([toks[-1][0], 5])
    pos = np.asarray([21, 9])
    live = np.asarray([True, False])
    jc, jn = jm.sample_step(jp, jnp.asarray(tok, jnp.int32)[:, None], jc,
                            jnp.asarray(pos, jnp.int32),
                            page_table=jnp.asarray(table2), paged_impl=impl,
                            write_mask=jnp.asarray(live))
    tc, tn = tm.sample_step(tp, torch.from_numpy(tok)[:, None], tc,
                            torch.from_numpy(pos),
                            page_table=torch.from_numpy(table2),
                            paged_impl=impl, write_mask=torch.from_numpy(live))
    assert tn.tolist() == np.asarray(jn).tolist()
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tc["layers"][leaf].numpy(),
                                   np.asarray(jc["layers"][leaf]),
                                   rtol=2e-5, atol=2e-5)
    # the masked-off second sequence wrote nothing: its row 9 is page 1's
    # row 1, never written, so still zero
    assert torch.count_nonzero(tc["layers"]["k"][:, 1]) == 0


# -- serving, token for token -------------------------------------------------

def _workload(vocab, seed=0):
    """Mixed lengths, shared prefixes and an exact resubmission (the
    workload of tests/test_serve_paged.py)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=(20,))
    reqs = []
    for i in range(3):          # 3 prompts sharing a 16-token (2-page) prefix
        tail = rng.integers(0, vocab, size=(3 + i,))
        reqs.append((np.concatenate([base[:16], tail]), 6))
    reqs.append((reqs[0][0].copy(), 4))          # identical full prompt
    for n, m in [(5, 8), (30, 10), (1, 3), (44, 5)]:
        reqs.append((rng.integers(0, vocab, size=(n,)), m))
    return reqs


def _run(srv, reqs, params, request_cls=Request):
    for i, (p, m) in enumerate(reqs):
        srv.submit(request_cls(rid=i, prompt=p, max_new_tokens=m))
    done = srv.run_until_drained(params)
    return {r.rid: list(r.out_tokens) for r in done}


_STATS = ("pages_peak", "prefix_hit_tokens", "cow_copies", "prefill_chunks")
_REF = {}


def _reference(quantized, decode_chunk, impl):
    key = (quantized, decode_chunk, impl)
    if key not in _REF:
        s = _setup()
        srv = JServer(s["jm"], batch_slots=3, max_len=MAX_LEN,
                      quantized=quantized, decode_chunk=decode_chunk,
                      paged=True, page_size=PS, prefill_chunk=16,
                      paged_attention=impl, gemm_impl="pallas")
        toks = _run(srv, _workload(s["cfg"].vocab), s["jp"], JRequest)
        _REF[key] = (toks, {k: srv.stats[k] for k in _STATS})
    return _REF[key]


def _contiguous(quantized, **kw):
    s = _setup()
    srv = BatchServer(s["tm"], batch_slots=3, max_len=MAX_LEN, device="cpu",
                      quantized=quantized, **kw)
    return _run(srv, _workload(s["cfg"].vocab), s["tp"])


@pytest.mark.parametrize("quantized,decode_chunk,impl", [
    (False, 1, "gather"), (False, 4, "gather"), (True, 1, "gather"),
    (True, 4, "gather"), (False, 4, "flash")])
def test_paged_serving_matches_reference(quantized, decode_chunk, impl):
    s = _setup()
    want, want_stats = _reference(quantized, decode_chunk, impl)
    srv = BatchServer(s["tm"], batch_slots=3, max_len=MAX_LEN, device="cpu",
                      quantized=quantized, gemm_impl="cuda",
                      decode_chunk=decode_chunk, paged=True, page_size=PS,
                      prefill_chunk=16, paged_attention=impl)
    got = _run(srv, _workload(s["cfg"].vocab), s["tp"])
    assert got == want
    assert got == _contiguous(quantized, gemm_impl="cuda")
    assert {k: srv.stats[k] for k in _STATS} == want_stats
    assert srv.stats["pages_peak"] < srv.b * srv.max_pages
    assert srv.stats["prefix_hit_tokens"] > 0
    assert srv._reserved == 0, "reservation ledger must drain"
    assert srv.alloc.free_count + srv.alloc.in_use == srv.alloc.num_pages


def test_chunked_prefill_equivalent_to_single_dispatch():
    s = _setup()
    want = _contiguous(False)
    for chunk in (PS, MAX_LEN):
        srv = BatchServer(s["tm"], batch_slots=3, max_len=MAX_LEN,
                          device="cpu", paged=True, page_size=PS,
                          prefill_chunk=chunk)
        assert _run(srv, _workload(s["cfg"].vocab), s["tp"]) == want
        if chunk == PS:   # the 30- and 44-token prompts split into chunks
            assert srv.stats["prefill_chunks"] > len(want)


def _run1(srv, params, rid, prompt, max_new):
    srv.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new))
    done = srv.run_until_drained(params)
    assert [r.rid for r in done] == [rid]
    return list(done[0].out_tokens)


def test_prefix_sharing_prefills_once_and_cows_shared_tail():
    s = _setup()
    srv = BatchServer(s["tm"], batch_slots=1, max_len=MAX_LEN, device="cpu",
                      paged=True, page_size=PS, prefill_chunk=PS)
    rng = np.random.default_rng(7)
    vocab = s["cfg"].vocab
    base = rng.integers(0, vocab, size=(20,))    # 2 full pages + 4 tail
    a = _run1(srv, s["tp"], 0, base, 4)
    assert srv.stats["prefix_hit_tokens"] == 0
    assert srv.stats["prefill_tokens"] == 20
    b_prompt = np.concatenate([base[:16], rng.integers(0, vocab, size=(6,))])
    _run1(srv, s["tp"], 1, b_prompt, 4)
    assert srv.stats["prefix_hit_tokens"] == 16
    assert srv.stats["prefill_tokens"] == 6
    # a verbatim resubmission hits the whole prompt, tail page included:
    # only the last token is recomputed, and the first decode write copies
    # the shared tail page
    c = _run1(srv, s["tp"], 2, base, 4)
    assert srv.stats["prefix_hit_tokens"] == 20
    assert srv.stats["prefill_tokens"] == 1
    assert srv.stats["cow_copies"] == 1
    assert c == a
    assert srv._reserved == 0


def test_long_prefill_interleaves_with_decode():
    s = _setup()
    srv = BatchServer(s["tm"], batch_slots=2, max_len=MAX_LEN, device="cpu",
                      paged=True, page_size=PS, prefill_chunk=PS,
                      prefix_sharing=False)
    rng = np.random.default_rng(9)
    vocab = s["cfg"].vocab
    srv.submit(Request(rid=0, prompt=rng.integers(0, vocab, size=(4,)),
                       max_new_tokens=20))
    srv.step(s["tp"])
    srv.step(s["tp"])                            # rid 0 is mid-decode
    srv.submit(Request(rid=1, prompt=rng.integers(0, vocab, size=(40,)),
                       max_new_tokens=4))
    srv.run_until_drained(s["tp"])
    ev = srv.events
    chunks = [i for i, e in enumerate(ev)
              if e[0] == "prefill_chunk" and e[1] == 1]
    assert len(chunks) == 5, "40-token prompt must split into 5 8-token chunks"
    for lo, hi in zip(chunks, chunks[1:]):
        assert any(e[0] == "decode" and 0 in e[1] for e in ev[lo:hi]), \
            "the active slot keeps decoding between the long prompt's chunks"


def test_paged_capacity_boundary_and_pool_exhaustion():
    s = _setup()
    tm, tp = s["tm"], s["tp"]
    rng = np.random.default_rng(11)
    p12 = rng.integers(0, s["cfg"].vocab, size=(12,))
    srv = BatchServer(tm, batch_slots=1, max_len=16, device="cpu",
                      paged=True, page_size=4)
    assert len(_run1(srv, tp, 0, p12, 5)) == 5   # fills max_len exactly
    assert srv.stats["pages_peak"] == 4
    with pytest.raises(ValueError):
        srv.submit(Request(rid=9, prompt=p12, max_new_tokens=6))
    srv2 = BatchServer(tm, batch_slots=2, max_len=16, device="cpu",
                       paged=True, page_size=4, num_pages=2)
    with pytest.raises(AdmissionImpossibleError):
        srv2.submit(Request(rid=0, prompt=p12, max_new_tokens=2))
    assert srv2._reserved == 0
    # a pool smaller than slots x max_pages queues: admission waits for
    # running requests to release pages, and everything completes
    srv3 = BatchServer(tm, batch_slots=2, max_len=16, device="cpu",
                       paged=True, page_size=4, num_pages=4,
                       prefix_sharing=False)
    prompts = [rng.integers(0, s["cfg"].vocab, size=(8,)) for _ in range(3)]
    for i, p in enumerate(prompts):              # each needs 3 of 4 pages
        srv3.submit(Request(rid=i, prompt=p, max_new_tokens=4))
    done = srv3.run_until_drained(tp)
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.out_tokens) == 4 for r in done)
    assert srv3.alloc.in_use == 0
    assert srv3._reserved == 0
    assert srv3.page_headroom() == 4


@pytest.mark.parametrize("kw", [
    dict(page_size=6),                           # not a power of two
    dict(max_len=50),                            # max_len not page-aligned
    dict(prefill_chunk=12),                      # chunk not page-aligned
    dict(paged_attention="dense"),
])
def test_paged_rejects_unsupported_configs(kw):
    s = _setup()
    args = dict(batch_slots=1, max_len=48, device="cpu", paged=True,
                page_size=8)
    args.update(kw)
    with pytest.raises(ValueError):
        BatchServer(s["tm"], **args)


def test_abort_mid_prefill_releases_reservation_and_keeps_index_clean():
    s = _setup()
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, s["cfg"].vocab, size=(30,))
    ref = BatchServer(s["tm"], batch_slots=1, max_len=MAX_LEN, device="cpu")
    want = _run1(ref, s["tp"], 0, prompt, 5)
    srv = BatchServer(s["tm"], batch_slots=2, max_len=MAX_LEN, device="cpu",
                      paged=True, page_size=PS, num_pages=12,
                      prefill_chunk=PS)
    srv.submit(Request(rid=0, prompt=prompt, max_new_tokens=5))
    srv.step(s["tp"])                 # admit + the first 8-token chunk
    assert srv.request_phase(0) == "prefilling"
    assert srv._reserved > 0
    assert srv.abort(0)
    assert srv._reserved == 0
    assert srv.alloc.free_count + srv.alloc.in_use == srv.num_pages
    assert len(srv.prefix) <= 1       # only the one finished page
    assert _run1(srv, s["tp"], 1, prompt, 5) == want
    assert srv._reserved == 0


def test_pool_churn_with_mid_prefill_aborts_never_leaks():
    s = _setup()
    rng = np.random.default_rng(12)
    vocab = s["cfg"].vocab
    base = rng.integers(0, vocab, size=(16,))
    prompts = [np.concatenate([base, rng.integers(0, vocab, size=(8,))])
               for _ in range(6)]
    srv = BatchServer(s["tm"], batch_slots=2, max_len=MAX_LEN, device="cpu",
                      paged=True, page_size=PS, num_pages=10,
                      prefill_chunk=PS)
    survivors = {}
    for i, p in enumerate(prompts):
        srv.submit(Request(rid=i, prompt=p, max_new_tokens=4))
        if i % 2 == 0:
            srv.step(s["tp"])         # partway into prefill...
            srv.abort(i)              # ...then gone
        else:
            for r in srv.run_until_drained(s["tp"]):
                survivors[r.rid] = list(r.out_tokens)
        assert srv.alloc.free_count + srv.alloc.in_use == srv.num_pages
    assert sorted(survivors) == [1, 3, 5]
    for rid, toks in survivors.items():
        ref = BatchServer(s["tm"], batch_slots=1, max_len=MAX_LEN,
                          device="cpu")
        assert toks == _run1(ref, s["tp"], 0, prompts[rid], 4), rid
    assert srv._reserved == 0
    assert srv.alloc.free_count + srv.alloc.in_use == srv.num_pages
    assert len(srv.prefix) <= srv.num_pages


def test_launch_serve_paged_cli_on_cpu(capsys):
    from repro_torch.launch import serve as launch
    launch.main(["--arch", "minicpm-2b", "--smoke", "--device", "cpu",
                 "--paged", "--shared-prefix", "--compare-contiguous"])
    out = capsys.readouterr().out
    assert "compare-contiguous: 64 tokens identical" in out
    assert "prefix_hit_tokens=" in out
    assert out.rstrip().endswith("OK")
