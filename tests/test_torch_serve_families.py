"""The four LM families' smoke models (gemma3-4b, mixtral-8x22b,
starcoder2-3b, deepseek-coder-33b) served by the port's ``BatchServer``
against the reference's, token for token, on the setups of
tests/test_torch_families.py (the reference's weights carried across by
repro_torch.bridge, bias and norm leaves drawn at random; JAX on the CPU).

* Contiguous, float and int8 FFIP at decode_chunk 1 and 4 under slot churn
  (tests/test_serve_fused.py's workload with every prompt past the window
  of 8): both chunks give the same tokens, and the reference server's.

tests/test_torch_paged_families.py holds the paged server the same way.

The port's GEMMs run through ``gemm_impl="cuda"`` (the kernels' plain
versions on the CPU) wherever the reference runs int8 FFIP.
"""
import numpy as np
import pytest

from repro.serve.batcher import BatchServer as JServer
from repro.serve.batcher import Request as JRequest
from repro_torch.serve.batcher import BatchServer, Request
from test_torch_families import ARCHS, MAX_LEN, _setup


def _run(srv, reqs, params, request_cls):
    for i, (p, m) in enumerate(reqs):
        srv.submit(request_cls(rid=i, prompt=p, max_new_tokens=m))
    done = srv.run_until_drained(params)
    return {r.rid: list(r.out_tokens) for r in done}


def _fused_workload(vocab):
    """Slot churn on 2 slots, every prompt past the window of 8, one
    request finishing at prefill."""
    rng = np.random.default_rng(7)
    lens, budgets = [12, 9, 21, 10, 17], [5, 1, 4, 6, 3]
    return [(rng.integers(0, vocab, size=(n,)), m)
            for n, m in zip(lens, budgets)]


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "int8-ffip"])
@pytest.mark.parametrize("arch", ARCHS)
def test_contiguous_server_tokens_match_reference(arch, quantized):
    jc, jm, jp, tc, tm, tp = _setup(arch)
    reqs = _fused_workload(tc.vocab)
    want = _run(JServer(jm, batch_slots=2, max_len=MAX_LEN,
                        quantized=quantized, decode_chunk=1), reqs, jp,
                JRequest)
    impl = "cuda" if quantized else None
    got = {c: _run(BatchServer(tm, batch_slots=2, max_len=MAX_LEN,
                               device="cpu", quantized=quantized,
                               gemm_impl=impl, decode_chunk=c), reqs, tp,
                   Request)
           for c in (1, 4)}
    assert sorted(got[1]) == list(range(len(reqs)))
    for i, (_, budget) in enumerate(reqs):
        assert len(got[1][i]) == budget
    assert got[1] == got[4]
    assert got[1] == want
