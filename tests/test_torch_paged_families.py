"""The four LM families' smoke models (gemma3-4b, mixtral-8x22b,
starcoder2-3b, deepseek-coder-33b) served from the port's paged cache
against the contiguous server and the reference's paged server, on the
setups of tests/test_torch_families.py (JAX on the CPU). This file holds
the check and gemma3-4b's cases; tests/test_torch_paged_{mixtral,
starcoder2,deepseek_coder}.py hold the other archs' cases, each a file of
its own so that a run split by file spreads them over its workers.

Paged, gather and flash (K5's plain version), float and int8 FFIP, on
tests/test_serve_paged.py's shared-prefix workload with attention_impl
"naive": the port's contiguous server's tokens and the reference's paged
server's, with its page counters (pages_peak, prefix hits, copy on write,
chunks). Most prompts pass the smoke window of 8.
"""
import numpy as np
import pytest

from repro.serve.batcher import BatchServer as JServer
from repro.serve.batcher import Request as JRequest
from repro_torch.serve.batcher import BatchServer, Request
from test_torch_families import MAX_LEN, _setup
from test_torch_serve_families import _run

PS = 8


def _paged_workload(vocab, seed=0):
    """tests/test_serve_paged.py's workload: mixed lengths (most past the
    window), shared prefixes and an exact resubmission."""
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


_STATS = ("pages_peak", "prefix_hit_tokens", "cow_copies", "prefill_chunks")


# (quantized, decode_chunk, paged_attention) of every arch's cases
PAGED_CASES = ("quantized,decode_chunk,paged_attention", [
    (False, 1, "gather"),
    (True, 4, "gather"),
    (False, 4, "flash"),
    (True, 1, "flash"),
])


def check_paged_tokens(arch, quantized, decode_chunk, paged_attention):
    """attention_impl "naive" as tests/test_serve_paged.py runs it: the
    gathered view and K5's plain version against the contiguous server's
    tokens and the reference's paged server, with its page counters."""
    jc, jm, jp, tc, tm, tp = _setup(arch, "naive")
    reqs = _paged_workload(tc.vocab)
    impl = "cuda" if quantized else None
    want = _run(BatchServer(tm, batch_slots=3, max_len=MAX_LEN, device="cpu",
                            quantized=quantized, gemm_impl=impl), reqs, tp,
                Request)
    kw = dict(batch_slots=3, max_len=MAX_LEN, quantized=quantized,
              decode_chunk=decode_chunk, paged=True, page_size=PS,
              prefill_chunk=16, paged_attention=paged_attention)
    srv = BatchServer(tm, device="cpu", gemm_impl=impl, **kw)
    got = _run(srv, reqs, tp, Request)
    assert got == want, {k: (got.get(k), want[k]) for k in want
                         if got.get(k) != want[k]}
    jsrv = JServer(jm, **kw)
    assert got == _run(jsrv, reqs, jp, JRequest)
    assert ({k: srv.stats[k] for k in _STATS}
            == {k: jsrv.stats[k] for k in _STATS})
    assert srv.stats["pages_peak"] < srv.b * srv.max_pages
    assert srv.stats["prefix_hit_tokens"] > 0
    assert srv._reserved == 0, "reservation ledger must drain"
    assert srv.alloc.free_count + srv.alloc.in_use == srv.alloc.num_pages


@pytest.mark.parametrize(*PAGED_CASES)
@pytest.mark.parametrize("arch", ["gemma3-4b"])
def test_paged_tokens_match_contiguous_and_reference(arch, quantized,
                                                     decode_chunk,
                                                     paged_attention):
    check_paged_tokens(arch, quantized, decode_chunk, paged_attention)
