"""The port's cost model (``repro_torch.launch.costs``, ``roofline``, the
kernels' meta paths, ``core.fip.count_multiplies``,
``obs.profile.dispatch_cost``) against the reference's.

* the aten walker against ``repro.launch.costs.fn_cost`` on the same
  shapes: a matmul, a batched matmul, a conv2d, a softmax, a reduction,
  FLOPs and bytes exactly equal; seven chained matmuls cost seven times
  one, their FLOPs exactly ``lax.scan``'s of seven and their bytes exactly
  the reference's unrolled chain's (a Python loop has no scan carry);
* ``roofline_report`` against the reference's at equal explicit peaks,
  key for key (the port adds only ``peak``), and the ring wire model
  against ``tests/test_dist.py``'s numbers;
* ``count_multiplies`` against ``count_multiplies_in_jaxpr`` and Eqs. 5/6,
  exactly (FIP, FFIP, baseline; an even and an odd M);
* ``kernel_cost`` reproducing ``PERF.md``'s kernel-table bounds;
* every kernel wrapper: a meta tensor outside a costing trace raises, one
  inside charges its kernel and counts a predicted launch, a CPU tensor
  takes the plain version; the training Functions trace their backward
  kernels on meta; the collectives of a shape-only mesh raise outside a
  trace and record inside one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import analytical as jan
from repro.core import fip as jfip
from repro.launch import costs as jcosts
from repro.launch import roofline as jroof
from repro_torch.core import fip as tfip
from repro_torch.dist import context as dctx
from repro_torch.kernels import compat
from repro_torch.kernels import conv_gemm, ffip_gemm, fip_gemm
from repro_torch.kernels import baseline_gemm as kbase
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import flash_paged as kpaged
from repro_torch.kernels import selective_scan as kscan
from repro_torch.launch import costs, roofline
from repro_torch.obs import profile

META = "meta"


def _sds(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _equal(port: costs.Cost, ref) -> None:
    assert (port.flops, port.bytes) == (ref.flops, ref.bytes)


CASES = {
    "matmul": (lambda a, b: a @ b, lambda a, b: a @ b,
               [(32, 128), (128, 16)]),
    "batched matmul": (lambda a, b: jnp.matmul(a, b),
                       lambda a, b: torch.matmul(a, b),
                       [(4, 8, 16), (4, 16, 8)]),
    "conv2d": (lambda x, w: jax.lax.conv_general_dilated(
        x, w, (1, 1), "VALID"), lambda x, w: F.conv2d(x, w),
        [(2, 3, 8, 8), (4, 3, 3, 3)]),
    "softmax": (jax.nn.softmax, lambda x: torch.softmax(x, -1), [(8, 32)]),
    "reduction": (lambda x: jnp.sum(x, axis=-1),
                  lambda x: torch.sum(x, dim=-1), [(8, 32)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_walker_equals_the_reference(name):
    jfn, tfn, shapes = CASES[name]
    _equal(costs.fn_cost(tfn, *[_meta(*s) for s in shapes]),
           jcosts.fn_cost(jfn, *[_sds(*s) for s in shapes]))


def test_seven_calls_cost_seven_times_one():
    def chain(a, b):
        for _ in range(7):
            a = a @ b
        return a

    def scan7(a, b):
        out, _ = jax.lax.scan(lambda x, _: (x @ b, None), a, None, length=7)
        return out

    a, b = _meta(64, 64), _meta(64, 64)
    one = costs.fn_cost(lambda a, b: a @ b, a, b)
    seven = costs.fn_cost(chain, a, b)
    assert seven.flops == 7 * one.flops
    ref = jcosts.fn_cost(scan7, _sds(64, 64), _sds(64, 64))
    assert seven.flops == ref.flops
    _equal(seven, jcosts.fn_cost(chain, _sds(64, 64), _sds(64, 64)))


def test_breakdown_tags():
    a, b = _meta(32, 128), _meta(128, 16)
    detail = costs.cost_breakdown(lambda a, b: torch.softmax(a @ b, -1),
                                  a, b)
    ref = jcosts.jaxpr_cost_breakdown(jax.make_jaxpr(
        lambda a, b: a @ b)(_sds(32, 128), _sds(128, 16)).jaxpr)
    assert set(ref) == {"dot 32x128 @ 128x16"}
    _equal(detail["dot 32x128 @ 128x16"], ref["dot 32x128 @ 128x16"])
    assert "_softmax" in detail
    rows = costs.top_costs(lambda a, b: a @ b, a, b, n=1)
    assert rows[0][0] == "dot 32x128 @ 128x16"


def test_roofline_report_equals_the_reference():
    for counts, by_kind in (({}, {}), ({"all-reduce": 30},
                                       {"all-reduce": 1.5e9})):
        ref = jroof.roofline_report(
            3.2e15, 1.1e12, jroof.CollectiveStats(counts, by_kind), 256,
            peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
            model_flops=2.5e15)
        port = roofline.roofline_report(
            3.2e15, 1.1e12, roofline.CollectiveStats(counts, by_kind), 256,
            peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
            model_flops=2.5e15)
        assert set(port) - set(ref) == {"peak"}
        assert {k: port[k] for k in ref} == ref
    # the defaults are the H100's, chosen by the compute dtype
    r = roofline.roofline_report(989e12 * 8, 0.0,
                                 roofline.CollectiveStats({}, {}), 8)
    assert r["compute_s"] == 1.0 and r["peak"]["unit"] == "bf16 tensor cores"
    r = roofline.roofline_report(1.0, 3.35e12, None, 1, dtype=torch.float32,
                                 collective_reason="why")
    assert r["collective_s"] is None and r["collective_reason"] == "why"
    assert r["bottleneck"] == "memory_s" and r["memory_s"] == 1.0
    assert r["peak"]["flops_s"] == costs.PEAK_OPS_S["cuda_core"]


def test_wire_model():
    # tests/test_dist.py:158-165: an all-gather of 256 f32 in groups of 8,
    # an all-reduce of 128 f32 in groups of 4
    assert roofline.wire_bytes("all-gather", 256 * 4, 8) == pytest.approx(
        256 * 4 * 7 / 8)
    assert roofline.wire_bytes("all-reduce", 128 * 4, 4) == pytest.approx(
        2 * 128 * 4 * 3 / 4)
    stats = roofline.collective_stats([("all-reduce", 128 * 4, 4)] * 30 + [
        ("all-gather", 256 * 4, 8)])
    assert stats.counts == {"all-reduce": 30, "all-gather": 1}
    assert stats.bytes_by_kind["all-reduce"] == pytest.approx(
        30 * 2 * 128 * 4 * 3 / 4)
    assert roofline.wire_bytes("reduce-scatter", 10, 4) == 30
    assert roofline.wire_bytes("collective-permute", 10, 4) == 10


@pytest.mark.parametrize("mkn", [(8, 16, 4), (7, 16, 4)])
def test_count_multiplies_equals_the_reference(mkn):
    m, k, n = mkn
    a, b = np.zeros((m, k), np.float32), np.zeros((k, n), np.float32)
    for name in ("fip_matmul", "ffip_matmul", "baseline_matmul"):
        ref = jfip.count_multiplies_in_jaxpr(getattr(jfip, name),
                                             jnp.asarray(a), jnp.asarray(b))
        port = tfip.count_multiplies(getattr(tfip, name),
                                     torch.from_numpy(a), torch.from_numpy(b))
        assert port == ref, name
    want = {"fip_matmul": jan.fip_mults(m, k, n),
            "baseline_matmul": jan.baseline_mults(m, k, n)}
    for name, n_mults in want.items():
        assert tfip.count_multiplies(getattr(tfip, name), _meta(m, k),
                                     _meta(k, n)) == n_mults


# PERF.md's kernel table: (kernel, shape, bound ms as printed, bound by)
BOUNDS = [
    ("baseline_gemm", dict(m=4, k=2304, n=5760, dtype="bf16"), "0.0080",
     "bytes"),
    ("baseline_gemm", dict(m=512, k=2304, n=5760, dtype="bf16"), "0.0137",
     "operations"),
    ("baseline_gemm", dict(m=4, k=2304, n=5760, dtype="int8"), "0.0040",
     "bytes"),
    ("fip_gemm", dict(m=512, k=2304, n=5760, dtype="bf16", fold_beta=False),
     "0.305", "operations"),
    ("ffip_gemm_y", dict(m=4, k=2304, n=5760, dtype="bf16", fold_beta=False),
     "0.0164", "bytes"),
    ("ffip_gemm_y", dict(m=128, k=4096, n=16384, dtype="bf16",
                         fold_beta=False), "0.386", "operations"),
    ("ffip_carry_table", dict(k=2304, n=5760), "0.0163", "bytes"),
    ("flash_fwd", dict(bh=144, sq=128, sk=128, d=64, dv=64, dtype="bf16",
                       window=0, causal=True), "0.0028", "bytes"),
    ("flash_fwd", dict(bh=48, sq=1500, sk=1500, d=64, dv=64, dtype="bf16",
                       window=0, causal=False), "0.0280", "operations"),
    ("flash_bwd", dict(bh=144, sq=256, sk=256, d=64, dv=64, dtype="bf16",
                       window=0, causal=True), "0.0155", "bytes"),
    ("selective_scan", dict(bt=1, s=128, di=8192, n=16, chunk=128,
                            dtype="bf16"), "0.00401", "operations"),
    ("selective_scan_bwd", dict(bt=2, s=256, di=8192, n=16, chunk=128),
     "0.0260", "bytes"),
    ("conv_gemm", dict(algo="ffip", dtype="f32", x_numel=8 * 58 * 58 * 64,
                       groups=1, ng=64, m=8 * 56 * 56, k=576,
                       fold_beta=False), "0.0417", "operations"),
]


@pytest.mark.parametrize("case", range(len(BOUNDS)))
def test_kernel_cost_reproduces_the_kernel_table(case):
    name, shape, printed, by = BOUNDS[case]
    ms, bound_by = costs.kernel_cost(name, **shape).bound_ms()
    digits = len(printed.split(".")[1])
    assert f"{ms:.{digits}f}" == printed and bound_by == by


def test_paged_cost_counts_this_call_s_data():
    shape = dict(b=2, h=4, sq=1, d=64, dv=64, kv=4, ps=16, max_pages=4,
                 dtype="bf16", window=0, causal=True)
    full = costs.kernel_cost("flash_paged", **shape)
    part = costs.kernel_cost("flash_paged", **shape, lengths=[64, 0],
                             q_start=[63, 0])
    assert part.flops == full.flops / 2
    assert part.bytes < full.bytes


def _wrapper_calls():
    """(name, call on (device) tensors) of every kernel wrapper."""
    bf, f32 = torch.bfloat16, torch.float32

    def t(dev, *shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return [
        ("baseline_gemm", lambda d: kbase.baseline_gemm(
            t(d, 4, 64, dtype=bf), t(d, 64, 64, dtype=bf), bm=16, bn=64,
            bk=64)),
        ("fip_gemm", lambda d: fip_gemm.fip_gemm(
            t(d, 4, 64), t(d, 64, 32), bm=16, bn=32, bk=32)),
        ("ffip_gemm_y", lambda d: ffip_gemm.ffip_gemm_y(
            t(d, 4, 64), t(d, 64, 32), bm=16, bn=32, bk=32)),
        ("ffip_carry_table", lambda d: ffip_gemm.carry_table(t(d, 64, 96))),
        ("flash_fwd", lambda d: kflash._flash_fwd(
            t(d, 2, 16, 64, dtype=bf), t(d, 2, 16, 64, dtype=bf),
            t(d, 2, 16, 64, dtype=bf))),
        ("flash_bwd", lambda d: kflash._flash_bwd(
            *[t(d, 2, 16, 64, dtype=bf) for _ in range(4)], t(d, 2, 16),
            t(d, 2, 16, 64, dtype=bf))),
        ("flash_paged", lambda d: kpaged.flash_attention_paged(
            t(d, 2, 4, 1, 64, dtype=bf), t(d, 8, 16, 4, 64, dtype=bf),
            t(d, 8, 16, 4, 64, dtype=bf),
            torch.zeros((2, 4), dtype=torch.int32, device=d), 16, 15)),
        ("selective_scan", lambda d: kscan.selective_scan(
            t(d, 1, 8, 32, dtype=bf), t(d, 1, 8, 32, dtype=bf),
            t(d, 1, 8, 16, dtype=bf), t(d, 1, 8, 16, dtype=bf), t(d, 32, 16),
            t(d, 1, 32, 16), chunk=8)),
        ("selective_scan_bwd", lambda d: kscan.selective_scan_bwd(
            t(d, 1, 8, 32), t(d, 1, 8, 32), t(d, 1, 8, 16), t(d, 1, 8, 16),
            t(d, 32, 16), t(d, 1, 1, 32, 16), t(d, 1, 8, 32), chunk=8)),
        ("conv_gemm", lambda d: conv_gemm.fused_conv_raw(
            t(d, 1, 6, 6, 4), t(d, 1, 36, 8), kh=3, kw=3, algo="fip",
            bm=64, bn=64, bk=32)),
    ]


@pytest.mark.parametrize("case", range(10))
def test_wrapper_meta_path(case):
    name, call = _wrapper_calls()[case]
    with pytest.raises(RuntimeError, match="costing trace"):
        call(META)
    with costs.CostMode() as mode:
        out = call(META)
        call("cpu")                       # the plain version: no launch
    assert mode.launches.get(name) == 1
    assert mode.total.bytes > 0
    for o in costs.tensors(out):
        assert o.device.type == "meta"
    assert compat.launch_counts()[name] == 0


def test_training_functions_trace_their_backward_kernels():
    bf = torch.bfloat16
    q, k, v = (torch.zeros((2, 16, 64), dtype=bf, device=META,
                           requires_grad=True) for _ in range(3))
    x = torch.zeros((1, 8, 32), device=META, requires_grad=True)
    a = torch.zeros((1, 64), device=META, requires_grad=True)
    w = torch.zeros((64, 32), device=META, requires_grad=True)
    with costs.CostMode() as mode:
        kflash.flash_attention(q, k, v).sum().backward()
        kscan.selective_scan_trainable(
            x, x, torch.zeros((1, 8, 16), device=META),
            torch.zeros((1, 8, 16), device=META),
            torch.zeros((32, 16), device=META),
            torch.zeros((1, 32, 16), device=META), chunk=8).sum().backward()
        tfip.fip_matmul_trainable(a, w).sum().backward()
    assert {n: mode.launches.get(n) for n in (
        "flash_fwd", "flash_bwd", "selective_scan",
        "selective_scan_bwd")} == dict.fromkeys(
            ("flash_fwd", "flash_bwd", "selective_scan",
             "selective_scan_bwd"), 1)
    assert q.grad.shape == q.shape and w.grad.shape == w.shape


def test_shape_only_collectives():
    mesh = dctx.make_mesh((1, 4), ("data", dctx.MODEL))
    assert not mesh.connected
    with dctx.mesh_context(mesh):
        with pytest.raises(RuntimeError, match="shape-only"):
            dctx.all_sum(_meta(8, 16))
        with pytest.raises(RuntimeError, match="shape-only"):
            dctx.all_sum(torch.zeros(8, 16))
        with costs.CostMode(), dctx.record_collectives() as records:
            s = dctx.all_sum(_meta(8, 16, dtype=torch.bfloat16))
            g = dctx.all_gather(_meta(8, 16), dim=1)
            m = dctx.all_max(_meta(8))
            with pytest.raises(RuntimeError, match="shape-only"):
                dctx.all_sum(torch.zeros(8))
    assert s.dtype == torch.bfloat16 and s.shape == (8, 16)
    assert g.shape == (8, 64) and m.shape == (8,)
    assert records == [("all-reduce", 8 * 16 * 4.0, 4),
                       ("all-reduce", 8 * 64 * 4.0, 4),
                       ("all-reduce", 8 * 4.0, 4)]


def test_dispatch_cost():
    a, b = torch.zeros(32, 128), torch.zeros(128, 16)
    flops, nbytes = profile.dispatch_cost(lambda a, b: a @ b, a, b)
    ref = jcosts.fn_cost(lambda a, b: a @ b, _sds(32, 128), _sds(128, 16))
    assert (flops, nbytes) == (ref.flops, ref.bytes)
    assert profile.dispatch_cost(lambda a: a.item(), a) is None


def test_live_storage_peak():
    with costs.CostMode(track_live=True) as mode:
        x = _meta(256, 256)                       # 256 KiB
        y = x.view(-1)                            # a view: no new storage
        z = x @ x                                 # 256 KiB more
        del y, z
        w = x + 1
    assert mode.peak_live_bytes == 2 * 256 * 256 * 4
    assert mode.live_bytes == 2 * 256 * 256 * 4
    del x, w
