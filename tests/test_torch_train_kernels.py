"""The training slice's kernels against the reference: K8 (flash backward)
and K9 (selective-scan backward), their plain versions and the autograd
Functions around K4 + K8 and K6 + K9; the FIP/FFIP trainable Functions; and
the guard that keeps the forward-only kernels (K1-K3, K5, K6's forward-only
entry point, K7) out of autograd.

Inputs come from numpy with a seed; the reference runs as its own tests run
it (JAX on the CPU, its Pallas kernels in interpret mode); the port runs on
CPU tensors, so every wrapper takes its plain version.

Bars:
- K8 and the flash Function: rtol 1e-4, atol 1e-4 * max|ref| (the same f32
  products, summed in another block order).
- K9 and the scan Function: rtol = atol = 1e-4 (the reference kernel's bar
  in tests/test_selective_scan.py).
- FIP/FFIP trainable Functions: rtol 1e-5 (the same f32 products; the
  backward is the baseline matmul on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fip as jfip
from repro.kernels import flash_attention as jfa
from repro.kernels import selective_scan as jss
from repro.models import attention as JA
from repro_torch import bridge
from repro_torch.core import fip
from repro_torch.core.gemm import GemmConfig, gemm, use_gemm
from repro_torch.kernels import compat, conv_gemm, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_paged
from repro_torch.kernels import selective_scan as ssk
from repro_torch.models import attention as A


def _np(x):
    return np.asarray(x, np.float64)


def _close_rel(got, want, rtol=1e-4):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _to_torch(x):
    return bridge.params_from_numpy(np.asarray(x))


# --- K8: flash backward -------------------------------------------------------

FLASH_CASES = [(64, 0, True), (96, 0, True), (96, 32, True), (64, 0, False),
               (96, 32, False)]


def _flash_inputs(bh, s, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (jnp.asarray(rng.standard_normal((bh, s, d)).astype(
        np.float32)).astype(dtype) for _ in range(4))
    return q, k, v, do


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,window,causal", FLASH_CASES)
def test_flash_bwd_plain_matches_reference(s, window, causal, dtype):
    q, k, v, do = _flash_inputs(2, s, 32, getattr(jnp, dtype))
    o, lse = jfa._flash_fwd(q, k, v, window, causal=causal, interpret=True)
    jdq, jdk, jdv = jfa._flash_bwd(q, k, v, o, lse, do, window,
                                   causal=causal, interpret=True)
    tq, tk, tv, to, tlse, tdo = map(_to_torch, (q, k, v, o, lse, do))
    got = fa._flash_bwd_plain(tq, tk, tv, to, tlse, tdo, window,
                              causal=causal)
    for g, w in zip(got, (jdq, jdk, jdv)):
        assert g.dtype == torch.float32
        _close_rel(g, w)
    # the wrapper takes the plain version for CPU tensors, counting nothing
    before = fa.bwd_counter.n
    again = fa._flash_bwd(tq, tk, tv, to, tlse, tdo, window, causal=causal)
    assert fa.bwd_counter.n == before
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("s,window,causal", FLASH_CASES)
def test_flash_function_grads_match_reference(s, window, causal):
    """jax.grad of the reference's custom VJP vs autograd through the
    port's Function (K4 forward, K8 backward), f32."""
    q, k, v, w = _flash_inputs(2, s, 32, jnp.float32, seed=1)

    def loss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention(q_, k_, v_, window, causal, True)
                       * w)

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_to_torch(t).requires_grad_(True) for t in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, window, causal)
    _close_rel(out.detach(), jfa.flash_attention(q, k, v, window, causal,
                                                 True))
    (out * _to_torch(w)).sum().backward()
    for t, jg in zip((tq, tk, tv), jgrads):
        assert t.grad.dtype == torch.float32
        _close_rel(t.grad, jg)


def test_flash_sdpa_gqa_grads_match_reference():
    """The attention layer's flash path with GQA: repeat_interleave sums the
    kv-head gradients as jnp.repeat's transpose does."""
    rng = np.random.default_rng(2)
    b, s, h, kv, hd = 2, 32, 4, 2, 16
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kv, hd)).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal((b, s, h, hd)).astype(np.float32)

    def loss(q_, k_, v_):
        return jnp.sum(JA._flash_sdpa(q_, k_, v_, 0, True) * w)

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    (A._flash_sdpa(tq, tk, tv, 0, True) * torch.from_numpy(w)).sum().backward()
    for t, jg in zip((tq, tk, tv), jgrads):
        _close_rel(t.grad, jg)


def _k8_on_the_tensor_cores(q, k, v, o, lse, do, window, causal, terms):
    """K8's bf16 arithmetic emulated with torch casts: s = q k^T and dp =
    do v^T from the bf16 operands as they are (exact products), p and ds in
    f32, then each product with p or ds as a sum over ``terms`` bf16 pieces
    of it (2: hi = bf16(x), lo = bf16(x - hi), the kernel's split; 1: one
    bf16 rounding, as FlashAttention-2 does), summed in f64."""
    f64 = torch.float64
    sq, d = q.shape[1], q.shape[2]
    scale = 1.0 / d ** 0.5
    s = torch.matmul(q.to(f64), k.to(f64).transpose(1, 2)).float()
    pos_q = torch.arange(sq)[:, None]
    pos_k = torch.arange(k.shape[1])[None, :]
    keep = torch.ones((sq, k.shape[1]), dtype=torch.bool)
    if causal:
        keep &= pos_q >= pos_k
    if window > 0:
        keep &= (pos_q - pos_k) < window
    p = torch.where(keep, torch.exp(s * scale - lse[..., None]), 0.0)
    delta = torch.sum(do.to(f64) * o.to(f64), -1, keepdim=True).float()
    dp = torch.matmul(do.to(f64), v.to(f64).transpose(1, 2)).float()
    ds = p * (dp - delta) * scale

    def pieces(x):
        out = []
        for _ in range(terms):
            out.append(x.to(torch.bfloat16).float())
            x = x - out[-1]
        return [t.to(f64) for t in out]

    dv = sum(t.transpose(1, 2) @ do.to(f64) for t in pieces(p))
    dk = sum(t.transpose(1, 2) @ q.to(f64) for t in pieces(ds))
    dq = sum(t @ k.to(f64) for t in pieces(ds))
    return dq.float(), dk.float(), dv.float()


def _within_card_bar(got, want) -> bool:
    """K8's bar on the card (tests/test_torch_cuda.py): rtol 1e-4, atol
    1e-4 * max|plain|, and once cast to bf16 one ulp beyond that atol."""
    atol = 1e-4 * float(want.abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=atol):
        return False
    w = want.to(torch.bfloat16).float()
    _, e = torch.frexp(w.abs().clamp_min(2.0 ** -126))
    ulp = torch.ldexp(torch.ones_like(w), e - 8)
    excess = ((got.to(torch.bfloat16).float() - w).abs() - atol).clamp_min(0)
    return float((excess / ulp).max()) <= 1.0


@pytest.mark.parametrize("s,window,causal", [
    (256, 0, True), (200, 0, True), (256, 32, True), (128, 0, False)])
def test_k8_hi_lo_split_holds_the_card_bar(s, window, causal):
    """K8 on the tensor cores splits its f32 operands p and ds into hi + lo
    bf16 and issues two MMAs. Emulated at FLASH_BWD_CASES' sequences (BH 4,
    d 64, bf16 inputs), dq, dk and dv stay within the card bar of
    _flash_bwd_plain; rounding p and ds once to bf16 leaves it."""
    rng = np.random.default_rng(s + window)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((4, s, 64)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    o, lse = fa._flash_fwd_plain(q, k, v, window, causal=causal)
    want = fa._flash_bwd_plain(q, k, v, o, lse, do, window, causal=causal)
    split = _k8_on_the_tensor_cores(q, k, v, o, lse, do, window, causal, 2)
    assert all(_within_card_bar(g, w) for g, w in zip(split, want))
    once = _k8_on_the_tensor_cores(q, k, v, o, lse, do, window, causal, 1)
    assert not any(_within_card_bar(g, w) for g, w in zip(once, want))


def test_flash_function_refuses_mla_widths():
    """MLA's widths (d 192 against dv 128) go through the Function: on the
    CPU its gradients are the plain versions', dv's of v's width. The card's
    operand check takes them in bf16 and refuses them in f32 (the f32
    kernels take d <= 128 and dv == d), naming ROADMAP queue 2 section A:
    never a fallback. bf16 takes up to gemma3's d 256 / dv 256 and refuses
    wider."""
    q, k = (torch.randn(2, 8, 24, requires_grad=True) for _ in range(2))
    v = torch.randn(2, 8, 16, requires_grad=True)
    o = fa.flash_attention(q, k, v)
    assert o.shape == (2, 8, 16)
    o.sum().backward()
    assert (q.grad.shape, k.grad.shape, v.grad.shape) == (
        q.shape, k.shape, v.shape)
    wide = [torch.zeros(2, 8, w) for w in (192, 192, 128)]
    fa._check_widths("flash_fwd", *[t.bfloat16() for t in wide])
    with pytest.raises(ValueError, match="queue 2 section A"):
        fa._check_widths("flash_fwd", *wide)
    fa._check_widths("flash_bwd", *[torch.zeros(2, 8, 256).bfloat16()] * 3)
    with pytest.raises(ValueError, match="queue 2 section A"):
        fa._check_widths("flash_bwd", *[torch.zeros(2, 8, 320).bfloat16()] * 3)
    with pytest.raises(ValueError, match="queue 2 section A"):
        fa._check_widths("flash_fwd", *[torch.zeros(2, 8, w).bfloat16()
                                        for w in (192, 192, 320)])


# --- K9: selective-scan backward -----------------------------------------------

def _scan_inputs(bt, s, di, n, seed=0):
    """tests/test_selective_scan.py's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bt, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bt, s, di)) - 1)).astype(
        np.float32)
    b = rng.standard_normal((bt, s, n)).astype(np.float32)
    c = rng.standard_normal((bt, s, n)).astype(np.float32)
    a = (-np.exp(rng.standard_normal((di, n)) * 0.3)).astype(np.float32)
    dy = rng.standard_normal((bt, s, di)).astype(np.float32)
    return x, dt, b, c, a, dy


@pytest.mark.parametrize("bt,s,di,n,chunk", [(2, 32, 16, 8, 8),
                                             (1, 24, 40, 4, 24)])
def test_scan_bwd_plain_matches_reference(bt, s, di, n, chunk):
    x, dt, b, c, a, dy = _scan_inputs(bt, s, di, n)
    h0 = np.zeros((bt, di, n), np.float32)
    jx = list(map(jnp.asarray, (x, dt, b, c, a, h0)))
    _, _, jstarts = jss.selective_scan(*jx, chunk=chunk, bd=8, interpret=True)
    want = jss.selective_scan_bwd(*jx[:5], jstarts, jnp.asarray(dy),
                                  chunk=chunk, bd=8, interpret=True)
    tx = [torch.from_numpy(t) for t in (x, dt, b, c, a)]
    _, _, starts = ssk.selective_scan_plain(*tx, torch.from_numpy(h0),
                                            chunk=chunk, bd=8)
    got = ssk.selective_scan_bwd_plain(*tx, starts, torch.from_numpy(dy),
                                       chunk=chunk, bd=8)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-4)
    before = ssk.bwd_counter.n
    again = ssk.selective_scan_bwd(*tx, starts, torch.from_numpy(dy),
                                   chunk=chunk, bd=8)
    assert ssk.bwd_counter.n == before
    assert all(torch.equal(p, q) for p, q in zip(again, got))


def test_sum_channels_is_the_kernel_tree():
    """The dB/dC block partials: 32 channels as four warps of eight, each
    warp a pairwise tree, then (0 + 1) + (2 + 3); channels past di add
    zeros."""
    p = torch.randn(2, 40, 3, dtype=torch.float64)
    got = ssk._sum_channels(p)
    assert got.shape == (2, 2, 3)
    torch.testing.assert_close(got[:, 0], p[:, :32].sum(1))
    torch.testing.assert_close(got[:, 1], p[:, 32:].sum(1))
    w = [((p[:, 8 * i] + p[:, 8 * i + 1]) + (p[:, 8 * i + 2] + p[:, 8 * i + 3]))
         + ((p[:, 8 * i + 4] + p[:, 8 * i + 5])
            + (p[:, 8 * i + 6] + p[:, 8 * i + 7])) for i in range(4)]
    assert torch.equal(got[:, 0], (w[0] + w[1]) + (w[2] + w[3]))


def test_scan_function_grads_match_reference():
    """jax.grad of selective_scan_trainable vs autograd through the port's
    Function (K6 forward, K9 backward): B 2, S 32, di 16, N 8, chunk 8."""
    x, dt, b, c, a, w = _scan_inputs(2, 32, 16, 8, seed=1)
    h0 = np.zeros((2, 16, 8), np.float32)

    def loss(*args):
        return jnp.sum(jss.selective_scan_trainable(*args, 8, 8) * w)

    jgrads = jax.grad(loss, argnums=(0, 1, 2, 3, 4, 5))(
        *map(jnp.asarray, (x, dt, b, c, a, h0)))
    tensors = [torch.from_numpy(t).requires_grad_(True)
               for t in (x, dt, b, c, a, h0)]
    y = ssk.selective_scan_trainable(*tensors, 8, 8)
    (y * torch.from_numpy(w)).sum().backward()
    for t, jg in zip(tensors, jgrads):
        np.testing.assert_allclose(_np(t.grad), _np(jg), rtol=1e-4,
                                   atol=1e-4)
    assert not tensors[5].grad.any()          # h0: zero, as the reference


# --- FIP / FFIP trainable Functions -----------------------------------------

@pytest.mark.parametrize("algo", ["fip", "ffip"])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_fip_trainable_matches_reference(algo, lead):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((*lead, 6, 12)).astype(np.float32)
    b = rng.standard_normal((12, 7)).astype(np.float32)
    w = rng.standard_normal((*lead, 6, 7)).astype(np.float32)
    jfn = (jfip.fip_matmul_trainable if algo == "fip"
           else jfip.ffip_matmul_trainable)
    tfn = (fip.fip_matmul_trainable if algo == "fip"
           else fip.ffip_matmul_trainable)
    jout = jfn(jnp.asarray(a), jnp.asarray(b), 2)
    jga, jgb = jax.grad(lambda a_, b_: jnp.sum(jfn(a_, b_, 2) * w),
                        argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(t).requires_grad_(True) for t in (a, b))
    out = tfn(ta, tb, 2)
    np.testing.assert_allclose(_np(out.detach()), _np(jout), rtol=1e-5,
                               atol=1e-5)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(ta.grad), _np(jga), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tb.grad), _np(jgb), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("algo", ["fip", "ffip"])
@pytest.mark.parametrize("impl", ["torch", "ref"])
def test_gemm_provider_trains_fip_through_the_functions(algo, impl):
    """core.gemm routes fip/ffip with impl torch/ref through the trainable
    Functions (the reference's core/gemm.py:128): the gradient is the
    baseline matmul's."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.standard_normal((5, 9)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((9, 4)).astype(np.float32))
    a.requires_grad_(True)
    b.requires_grad_(True)
    with use_gemm(GemmConfig(algo=algo, impl=impl)):
        out = gemm(a, b)
    assert out.shape == (5, 4)
    out.sum().backward()
    ones = torch.ones(5, 4)
    torch.testing.assert_close(a.grad, ones @ b.detach().T)
    torch.testing.assert_close(b.grad, a.detach().T @ ones)


# --- the forward-only kernels refuse autograd ---------------------------------

def _guarded_calls():
    g = torch.Generator().manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    a, b = rnd(4, 8), rnd(8, 6)
    q = rnd(1, 2, 1, 16)
    pool_k, pool_v = rnd(2, 4, 2, 16), rnd(2, 4, 2, 16)
    table = torch.tensor([[0, 1]], dtype=torch.int32)
    x, kern = rnd(1, 6, 6, 4), rnd(3, 3, 4, 8)
    sx, sdt = rnd(1, 8, 8), torch.rand(1, 8, 8)
    sb, sc, sa, sh = rnd(1, 8, 4), rnd(1, 8, 4), -torch.rand(8, 4), rnd(1, 8,
                                                                        4)
    calls = {f"matmul {algo}": ((a, b), lambda a_, b_, al=algo: ops.matmul(
        a_, b_, algo=al)) for algo in ops.ALGOS}
    calls["flash_attention_paged"] = (
        (q, pool_k, pool_v),
        lambda q_, k_, v_: flash_paged.flash_attention_paged(
            q_, k_, v_, table, torch.tensor([6]), torch.tensor([5])))
    calls["conv_gemm"] = ((x, kern), lambda x_, k_: conv_gemm.conv_gemm_fused(
        x_, k_, pad=1, algo="ffip"))
    calls["selective_scan"] = (
        (sx, sdt, sb, sc, sa, sh),
        lambda *t: ssk.selective_scan(*t, chunk=4, bd=8)[0])
    return calls


@pytest.mark.parametrize("name", list(_guarded_calls()))
def test_forward_only_kernels_refuse_grad(name):
    """With grad on and an operand that requires grad, each forward-only
    wrapper raises on the CPU as it does on the card (the reference's Pallas
    kernels have no gradient); under torch.no_grad() it runs unchanged."""
    args, fn = _guarded_calls()[name]
    want = fn(*args)
    for i in range(len(args)):
        if not args[i].is_floating_point():
            continue
        marked = list(args)
        marked[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(NotImplementedError, match="no gradient"):
            fn(*marked)
        with torch.no_grad():
            assert torch.equal(fn(*marked), want)
    compat.refuse_grad("nothing", *args)      # no operand requires grad
