"""The port's BatchServer against the reference's, token for token.

Workload: the minicpm-2b smoke config, 2 slots, 6 mixed-length requests with
max_new_tokens 4 (the verify recipe's serve smoke), plus one max_len-token
prompt with max_new_tokens=1 at the cache_rows boundary. Weights come from
the reference's init, carried across by repro_torch.bridge. The port runs
with gemm_impl="cuda" on CPU tensors, so every kernel wrapper takes its plain
version; the reference runs BatchServer(gemm_impl="pallas") in interpret
mode. Each reference runs once per module; its tokens do not depend on
decode_chunk (the fused decode is bit-identical to stepping), so both port
chunk sizes compare against it. Bar: identical token streams.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models.model import build_model as j_build
from repro.serve.batcher import BatchServer as JServer
from repro.serve.batcher import Request as JRequest
from repro_torch import bridge, configs
from repro_torch.models.model import Model
from repro_torch.serve.batcher import BatchServer, Request
from repro_torch.serve.lifecycle import AdmissionImpossibleError

MAX_LEN = 64
SLOTS = 2


def _prompts(vocab):
    rng = np.random.default_rng(0)
    lens = rng.integers(3, 12, 6)
    prompts = [rng.integers(0, vocab, size=(int(n),)) for n in lens]
    boundary = rng.integers(0, vocab, size=(MAX_LEN,))
    return [(p, 4) for p in prompts] + [(boundary, 1)]


@pytest.fixture(scope="module")
def workload():
    jc = jcfg.smoke_config(jcfg.get_config("minicpm-2b"))
    jm = j_build(jc)
    jparams = jm.init(jax.random.PRNGKey(0))
    reqs = _prompts(jc.vocab)
    want = {}
    for quantized in (False, True):
        srv = JServer(jm, batch_slots=SLOTS, max_len=MAX_LEN,
                      quantized=quantized, gemm_impl="pallas",
                      decode_chunk=4)
        for i, (p, n) in enumerate(reqs):
            srv.submit(JRequest(rid=i, prompt=p, max_new_tokens=n))
        want[quantized] = {r.rid: list(r.out_tokens)
                           for r in srv.run_until_drained(jparams)}
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return reqs, params, want


def _serve(params, reqs, **kw):
    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    srv = BatchServer(Model(cfg, device="cpu"), batch_slots=SLOTS,
                      max_len=MAX_LEN, device="cpu", **kw)
    for i, (p, n) in enumerate(reqs):
        srv.submit(Request(rid=i, prompt=p, max_new_tokens=n))
    return srv, {r.rid: list(r.out_tokens)
                 for r in srv.run_until_drained(params)}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_tokens_match_reference(workload, quantized, decode_chunk):
    reqs, params, want = workload
    _, got = _serve(params, reqs, gemm_impl="cuda", quantized=quantized,
                    decode_chunk=decode_chunk)
    assert got == want[quantized]
    assert all(len(got[i]) == n for i, (_, n) in enumerate(reqs))


def test_cache_rows_boundary(workload):
    reqs, params, _ = workload
    assert BatchServer.cache_rows(MAX_LEN, 1) == MAX_LEN
    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    srv = BatchServer(Model(cfg, device="cpu"), batch_slots=SLOTS,
                      max_len=MAX_LEN, device="cpu")
    with pytest.raises(AdmissionImpossibleError):
        srv.submit(Request(rid=0, prompt=reqs[-1][0], max_new_tokens=2))


def test_duplicate_rid_served_once(workload):
    reqs, params, want = workload
    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    srv = BatchServer(Model(cfg, device="cpu"), batch_slots=SLOTS,
                      max_len=MAX_LEN, device="cpu", gemm_impl="cuda")
    p, n = reqs[0]
    srv.submit(Request(rid=7, prompt=p, max_new_tokens=n))
    srv.submit(Request(rid=7, prompt=p, max_new_tokens=n))
    done = srv.run_until_drained(params)
    assert [r.out_tokens for r in done] == [want[False][0]] * 2
    assert srv.stats["prefill_dispatches"] == 1


def test_server_owns_its_weight_memo():
    """The y-deltas a server prepares live in its own memo, not the
    module-level one, and are freed as soon as the server is dropped (no
    reference cycle waits for the garbage collector)."""
    import gc
    import weakref

    from repro_torch.kernels import compat

    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    model = Model(cfg, device="cpu")
    params = model.init(0)
    compat.derived.clear()
    gc.disable()
    try:
        srv = BatchServer(model, batch_slots=SLOTS, max_len=MAX_LEN,
                          device="cpu", gemm_impl="cuda", gemm_algo="ffip")
        srv.submit(Request(rid=0, prompt=np.arange(5), max_new_tokens=2))
        srv.run_until_drained(params)
        # 7 projections x n_layers views, plus the tied unembed
        assert len(srv._derived) == 7 * cfg.n_layers + 1
        assert len(compat.derived) == 0
        memo = weakref.ref(srv._derived)
        y = weakref.ref(next(iter(srv._derived._cache.values()))[2])
        del srv
        assert memo() is None and y() is None
    finally:
        gc.enable()


def test_launch_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve as launch
    launch.main(["--arch", "minicpm-2b", "--smoke", "--device", "cpu",
                 "--slots", "2", "--requests", "3", "--max-new", "3",
                 "--gemm-impl", "cuda", "--decode-chunk", "2"])
    out = capsys.readouterr().out
    assert "3/3 requests / 9 tokens" in out
    assert out.rstrip().endswith("OK")


def test_unported_options_raise():
    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    m = Model(cfg, device="cpu")
    for kw in ({"paged": True}, {"mesh": object()}, {"prepared": object()}):
        with pytest.raises(NotImplementedError):
            BatchServer(m, batch_slots=1, max_len=8, device="cpu", **kw)
    assert torch.device("cpu") == m.device
