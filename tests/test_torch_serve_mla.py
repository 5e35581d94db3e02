"""deepseek-v2-lite-16b (MLA + MoE) served by the port's BatchServer against
the reference's, token for token, on the smoke config (JAX on the CPU, the
reference's weights carried across by repro_torch.bridge).

* The deepseek cases of tests/test_serve_fused.py's
  test_fused_decode_chunk_equivalence: decode_chunk 1 and 4 give the same
  tokens under slot churn (5 requests on 2 slots, a budget-1 request that
  finishes at prefill), float and int8 FFIP, and both equal the reference
  server's.
* The deepseek cases of tests/test_serve_paged.py's
  test_paged_bit_identical_to_contiguous, on its shared-prefix workload
  (attention_impl "naive", as there): paged gather and flash (K5's plain
  version), float and int8 FFIP, decode_chunk 1 and 4, each identical to the
  port's contiguous server and to the reference's paged server, with the
  same page counters.
* The launchers take ``--arch deepseek-v2-lite-16b``; ``moe_partition``
  is validated ("expert" or "ffn"; it partitions the banks over a mesh,
  tests/test_torch_dist_serve.py).

The port's GEMMs run through ``gemm_impl="cuda"`` (the kernels' plain
versions on the CPU) wherever the reference runs FFIP or int8.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jcfg
from repro.models.model import build_model as j_build
from repro.serve.batcher import BatchServer as JServer
from repro.serve.batcher import Request as JRequest
from repro_torch import bridge, configs
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.model import Model
from repro_torch.serve.batcher import BatchServer, Request

ARCH = "deepseek-v2-lite-16b"
MAX_LEN = 48
PS = 8
_MODELS = {}


def _setup(impl):
    """(reference model, its params, port model, the same params) for
    attention_impl ``impl``."""
    if impl not in _MODELS:
        jc = dataclasses.replace(jcfg.smoke_config(jcfg.get_config(ARCH)),
                                 attention_impl=impl)
        jm = j_build(jc)
        jp = jm.init(jax.random.PRNGKey(0))
        tc = dataclasses.replace(configs.smoke_config(configs.get_config(
            ARCH)), attention_impl=impl)
        tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
        _MODELS[impl] = (jm, jp, Model(tc, device="cpu"), tp)
    return _MODELS[impl]


def _run(srv, reqs, params, request_cls):
    for i, (p, m) in enumerate(reqs):
        srv.submit(request_cls(rid=i, prompt=p, max_new_tokens=m))
    done = srv.run_until_drained(params)
    return {r.rid: list(r.out_tokens) for r in done}


# -- fused decode chunks (tests/test_serve_fused.py) ---------------------------

def _fused_workload(vocab):
    rng = np.random.default_rng(7)
    lens, budgets = [3, 6, 9, 4, 7], [5, 1, 3, 6, 2]
    return [(rng.integers(0, vocab, size=(n,)), m)
            for n, m in zip(lens, budgets)]


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "int8-ffip"])
def test_fused_decode_chunk_equivalence(quantized):
    jm, jp, tm, tp = _setup("flash")
    reqs = _fused_workload(tm.cfg.vocab)
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


# -- paged against contiguous (tests/test_serve_paged.py) ----------------------

def _paged_workload(vocab, seed=0):
    """Mixed lengths, shared prefixes and an exact resubmission."""
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
_CONTIGUOUS = {}


def _contiguous(quantized):
    if quantized not in _CONTIGUOUS:
        jm, jp, tm, tp = _setup("naive")
        reqs = _paged_workload(tm.cfg.vocab)
        got = _run(BatchServer(tm, batch_slots=3, max_len=MAX_LEN,
                               device="cpu", quantized=quantized,
                               gemm_impl="cuda" if quantized else None),
                   reqs, tp, Request)
        want = _run(JServer(jm, batch_slots=3, max_len=MAX_LEN,
                            quantized=quantized), reqs, jp, JRequest)
        assert got == want
        _CONTIGUOUS[quantized] = got
    return _CONTIGUOUS[quantized]


@pytest.mark.parametrize("quantized,decode_chunk,paged_attention", [
    (False, 1, "gather"),
    (False, 4, "gather"),
    (True, 4, "gather"),
    (False, 4, "flash"),
    (True, 1, "flash"),
])
def test_paged_bit_identical_to_contiguous(quantized, decode_chunk,
                                           paged_attention):
    jm, jp, tm, tp = _setup("naive")
    reqs = _paged_workload(tm.cfg.vocab)
    kw = dict(batch_slots=3, max_len=MAX_LEN, quantized=quantized,
              decode_chunk=decode_chunk, paged=True, page_size=PS,
              prefill_chunk=16, paged_attention=paged_attention)
    srv = BatchServer(tm, device="cpu",
                      gemm_impl="cuda" if quantized else None, **kw)
    got = _run(srv, reqs, tp, Request)
    want = _contiguous(quantized)
    assert got == want, {k: (got.get(k), want[k]) for k in want
                         if got.get(k) != want[k]}
    jsrv = JServer(jm, **kw)
    assert got == _run(jsrv, reqs, jp, JRequest)
    assert ({k: srv.stats[k] for k in _STATS}
            == {k: jsrv.stats[k] for k in _STATS})
    # prefix sharing keeps the footprint under the contiguous equivalent
    assert srv.stats["pages_peak"] < srv.b * srv.max_pages
    assert srv.stats["prefix_hit_tokens"] > 0
    assert srv._reserved == 0, "reservation ledger must drain"
    assert srv.alloc.free_count + srv.alloc.in_use == srv.alloc.num_pages


# -- launchers -----------------------------------------------------------------

def test_launchers_take_deepseek(capsys):
    launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--slots", "2", "--requests", "4", "--max-new", "3",
                       "--gemm-impl", "cuda", "--paged", "--shared-prefix",
                       "--paged-attention", "flash", "--prefill-chunk", "16",
                       "--max-len", "48", "--compare-contiguous"])
    out = capsys.readouterr().out
    assert "4/4 requests" in out and "OK" in out
    got = launch_train.main(["--arch", ARCH, "--smoke", "--layers", "3",
                             "--device", "cpu", "--steps", "3", "--batch",
                             "2", "--seq", "16"])
    assert all(np.isfinite(h["loss"]) for h in got["history"])
    assert got["params"]["layers"]["ffn"]["w_gate"].shape[0] == 2
    assert "3 layers" in capsys.readouterr().out
    # the published depth needs the mesh; a cut depth needs MoE layers
    for argv in (["--arch", ARCH], ["--arch", ARCH, "--layers", "1"]):
        with pytest.raises(SystemExit, match="item 15|dense head"):
            launch_train.main(argv + ["--device", "cpu"])
    _, _, tm, _ = _setup("flash")
    with pytest.raises(ValueError, match="moe_partition"):
        BatchServer(tm, batch_slots=2, max_len=MAX_LEN, device="cpu",
                    moe_partition="bogus")
    for part in ("expert", "ffn"):
        assert BatchServer(tm, batch_slots=2, max_len=MAX_LEN, device="cpu",
                           moe_partition=part).moe_partition == part
