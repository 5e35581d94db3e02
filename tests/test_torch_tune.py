"""The port's kernel autotuner (``repro_torch.tune``, ``launch/tune.py``)
against the reference's (``repro.tune``) on the CPU.

Keys and buckets are the reference's strings for the same shapes and
dtypes; each package reads the other's ``REPRO_TUNE_CACHE`` file. The
port's space holds only the tiles its kernels are compiled for, the static
default first; a cached entry holding any other block (the reference's
``cpu`` entries in a shared file) is a miss, never a kernel's block. On the
CPU the tuner times the kernels' plain versions: these tests check its
logic, not times. ``block="auto"`` on the LM (float and int8), vision and
flash paths gives the static default's results bit for bit.
"""
import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tune as jtune
from repro.tune import cache as jcache
from repro.tune import space as jspace
from repro_torch import configs, tune
from repro_torch.core.gemm import GemmConfig, use_gemm
from repro_torch.kernels import ops
from repro_torch.launch import tune as launch_tune
from repro_torch.models.model import Model
from repro_torch.tune import cache as tcache
from repro_torch.tune import measure, space
from repro_torch.vision import layers as vl

DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
          (torch.int8, jnp.int8)]
SHAPES = [(4, 2304, 5760), (512, 2304, 122753), (1, 3, 5), (100, 60, 36),
          (17, 8192, 288)]


@pytest.fixture(autouse=True)
def _own_cache(tmp_path, monkeypatch):
    """Every test reads and writes its own schedule file."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "sched.json"))
    tune.reset_stats()
    yield
    tune.reset_stats()


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small torch ops: one intra-op thread keeps them from contending
    with the other test workers' threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- keys, buckets and the space ---------------------------------------------

@pytest.mark.parametrize("dt,jdt", DTYPES, ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_keys_match_reference(dt, jdt, m, k, n):
    for algo in ("baseline", "fip", "ffip"):
        assert (tune.gemm_key(algo, dt, m, n, k, device="cpu")
                == jtune.gemm_key(algo, jdt, m, n, k, device="cpu"))
        assert (tune.conv_key(algo, dt, m, n, k, 3 * k, device="X")
                == jtune.conv_key(algo, jdt, m, n, k, 3 * k, device="X"))
    assert (tune.flash_key(dt, m * 4, k % 300 + 1, n % 500 + 1, 64,
                           device="cpu")
            == jtune.flash_key(jdt, m * 4, k % 300 + 1, n % 500 + 1, 64,
                               device="cpu"))
    assert tcache.default_cache_path() == jcache.default_cache_path()


def test_round_up_pow2_matches_reference():
    for x in list(range(0, 300)) + [2304, 5760, 122753, 2 ** 20 + 1]:
        for lo in (1, 2, 8, 64):
            assert space.round_up_pow2(x, lo) == jspace.round_up_pow2(x, lo)
    assert tune.device_kind() == "cpu" == jtune.device_kind()


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.int8])
def test_default_first_and_every_candidate_compiled(dt):
    from repro_torch.kernels import conv_gemm, flash_attention
    from repro_torch.kernels.baseline_gemm import kernel_tm, tc_geom
    from repro_torch.kernels.fip_gemm import pair_geom
    for m, k, n in SHAPES + [(4, 64, 64), (64, 64, 64), (8, 4096, 131072)]:
        for algo in ("baseline", "fip", "ffip"):
            mb, nb, kb = (space.round_up_pow2(v) for v in (m, n, k))
            cands = space.gemm_candidates(mb, nb, kb, algo, dt)
            assert cands[0] == ops.choose_blocks(mb, nb, kb, algo, dt)
            assert len(set(cands)) == len(cands)
            for bm, bn, bk in cands:
                if algo != "baseline":
                    pair_geom(bm, bn, bk)             # raises otherwise
                elif dt == torch.float32:
                    kernel_tm(bm, bn, bk)
                else:
                    tc_geom(bm, bn, bk, dt)
            # the reference's ordering past the default
            d = cands[0]
            dist = [sum(abs(x.bit_length() - y.bit_length())
                        for x, y in zip(c, d)) for c in cands[1:]]
            assert dist == sorted(dist)
            cc = space.conv_candidates(m, n, k, 9, algo)
            k_even = k + k % 2 if algo != "baseline" else k
            assert cc[0] == conv_gemm.conv_blocks(m, n, k_even, algo)
            for bm, bn, bk in cc:             # K7's bodies, any dtype
                if algo == "baseline":
                    kernel_tm(bm, bn, bk)
                else:
                    pair_geom(bm, bn, bk)
    for sq in (1, 16, 17, 32, 33, 512):
        fl = space.flash_candidates(sq, sq, dt)
        assert fl == [flash_attention.kernel_blocks(dt, sq)]
    # decode keeps the smallest tile only; prefill offers them all
    assert space.gemm_candidates(8, 8192, 4096, "ffip", dt) == [(16, 32, 32)]
    assert len(space.gemm_candidates(512, 8192, 4096, "ffip", dt)) == 3


# -- the cache ---------------------------------------------------------------

_ENTRY = {"blocks": {"bm": 64, "bn": 64, "bk": 32}, "us": 10.0,
          "candidates": 3}


def test_cache_roundtrip_corruption_merge_atomic(tmp_path):
    path = tmp_path / "c.json"
    c = tcache.ScheduleCache(path)
    c.put("k1", _ENTRY)
    assert json.loads(path.read_text())["version"] == jcache._VERSION
    assert tcache.ScheduleCache(path).lookup("k1") == _ENTRY
    # a second writer's entries survive our save (merge on save)
    other = tcache.ScheduleCache(path)
    other.put("k2", _ENTRY)
    c.put("k3", _ENTRY)
    assert tcache.ScheduleCache(path).keys() == ["k1", "k2", "k3"]
    # atomic overwrite leaves no temporary file behind
    assert not path.with_name(path.name + ".tmp").exists()
    # corruption: quarantined aside, the cache restarts empty
    path.write_text("{garbage")
    fresh = tcache.ScheduleCache(path)
    assert fresh.lookup("k1") is None and fresh.recovered
    assert path.with_name(path.name + ".corrupt").exists()
    fresh.put("k4", _ENTRY)
    assert tcache.ScheduleCache(path).keys() == ["k4"]
    # a corrupt file met at save time is quarantined, not overwritten
    path.write_text("{garbage again")
    fresh.put("k5", _ENTRY)
    assert (path.with_name(path.name + ".corrupt").read_text()
            == "{garbage again")
    assert set(tcache.ScheduleCache(path).keys()) == {"k4", "k5"}
    # the device slice of an artifact
    fresh.merge_entries({"gemm|a|b|c|dev1": _ENTRY,
                         "gemm|a|b|c|dev2": _ENTRY, "bad": {"blocks": 3}})
    assert list(fresh.entries_for_device("dev1")) == ["gemm|a|b|c|dev1"]


def test_reference_cache_file_reads_in_port_and_back():
    """One REPRO_TUNE_CACHE file: the reference's tuner writes a real entry
    (its interpret-mode kernel, on the CPU), the port reads it, the port's
    tuner adds one, the reference reads that. The reference's block is no
    tile of the port's kernels, so the port's lookup of that key misses."""
    entry = jtune.tune_gemm(8, 32, 32, jnp.int8, algo="ffip", budget=1,
                            iters=1)
    key = jtune.gemm_key("ffip", jnp.int8, 8, 32, 32)
    assert tune.gemm_key("ffip", torch.int8, 8, 32, 32) == key
    assert tune.get_cache().lookup(key) == entry
    mine = tune.tune_gemm(8, 64, 64, torch.int8, algo="ffip", iters=1,
                          device="cpu")
    mkey = tune.gemm_key("ffip", torch.int8, 8, 64, 64)
    assert jcache.ScheduleCache(jcache.default_cache_path()).lookup(
        mkey) == mine
    got = tuple(entry["blocks"][x] for x in ("bm", "bn", "bk"))
    assert got not in space.compiled_tiles("ffip", torch.int8)
    assert tune.lookup_gemm_blocks("ffip", torch.int8, 8, 32, 32) is None
    assert tune.stats == {"hits": 0, "misses": 1}


def test_foreign_cpu_entry_is_a_miss_logged_once(caplog):
    key = tune.gemm_key("ffip", torch.bfloat16, 4, 64, 64)
    tune.get_cache().put(key, {"blocks": {"bm": 8, "bn": 128, "bk": 64},
                               "us": 1.0})
    with caplog.at_level(logging.INFO, logger="repro_torch.tune"):
        for _ in range(3):
            assert tune.lookup_gemm_blocks("ffip", torch.bfloat16, 4, 64,
                                           64) is None
    assert tune.stats == {"hits": 0, "misses": 3}
    logs = [r for r in caplog.records if key in r.getMessage()]
    assert len(logs) == 1 and "not a tile" in logs[0].getMessage()


def test_miss_falls_back_with_one_log_per_key(caplog):
    with caplog.at_level(logging.INFO, logger="repro_torch.tune"):
        for m in (3, 4, 5, 100):        # three share the m8 bucket
            assert tune.lookup_gemm_blocks("fip", torch.float32, m, 64,
                                           64) is None
    assert tune.stats["misses"] == 4
    assert len([r for r in caplog.records
                if "no tuned schedule" in r.getMessage()]) == 2


def test_warm_tune_gemm_measures_nothing():
    before = measure.counters["timed_candidates"]
    e1 = tune.tune_gemm(64, 96, 64, torch.float32, algo="ffip", iters=1,
                        device="cpu")
    n = measure.counters["timed_candidates"] - before
    assert n == e1["candidates"] == len(space.gemm_candidates(
        64, 128, 64, "ffip", torch.float32))
    assert e1["default_blocks"] == {"bm": 64, "bn": 64, "bk": 32}
    e2 = tune.tune_gemm(50, 100, 60, torch.float32, algo="ffip",
                        device="cpu")           # the same bucket
    assert e2 == e1
    assert measure.counters["timed_candidates"] - before == n
    assert (tune.lookup_gemm_blocks("ffip", torch.float32, 64, 96, 64)
            == tuple(e1["blocks"].values()))
    assert tune.stats["hits"] == 1


def test_conv_and_flash_tuning_keep_their_tile():
    e = tune.tune_conv(2, 9, 9, 4, 8, 3, 3, torch.int8, pad=1, algo="ffip",
                       iters=1, device="cpu")
    assert e["geometry"]["pad"] == [1, 1] and e["candidates"] >= 1
    assert (tune.lookup_conv_blocks("ffip", torch.int8, 81, 8, 36, 12)
            == tuple(e["blocks"].values()))
    f = tune.tune_flash(8, 20, 20, 16, torch.bfloat16, iters=1,
                        device="cpu")
    assert f["blocks"] == {"bq": 32, "bk": 64} and f["candidates"] == 1
    assert tune.lookup_flash_blocks(torch.bfloat16, 8, 17, 30, 16) == (32,
                                                                        64)


def test_launch_tune_expect_cached(capsys):
    argv = ["--arch", "minicpm-2b", "--smoke", "--m", "4,64", "--algos",
            "ffip,baseline", "--dtypes", "float32,int8", "--iters", "1",
            "--seq", "16", "--slots", "2", "--device", "cpu"]
    assert launch_tune.main(argv + ["--expect-cached"]) == 1   # cold
    out = capsys.readouterr().out
    assert "buckets tuned / 0 reused" in out
    assert launch_tune.main(argv + ["--expect-cached"]) == 0   # warm
    out = capsys.readouterr().out
    assert " 0 buckets tuned" in out and "(0 candidates timed" in out
    assert "[tuned ]" not in out


# -- block="auto" on the served paths ----------------------------------------

def _far_tiles():
    """Fill every key the misses named with the compiled tile farthest from
    the default (a hit that is no default)."""
    c = tune.get_cache()
    for key in sorted(tune._warned_keys):
        kernel, algo, dtype = key.split("|")[:3]
        dt = getattr(torch, dtype)
        if kernel == "flash_attention":
            bq, bk = space.flash_candidates(
                int(key.split("sq")[1].split("sk")[0]), 0, dt)[0]
            c.put(key, {"blocks": {"bq": bq, "bk": bk}, "us": 1.0},
                  persist=False)
        else:
            tiles = (space.compiled_conv_tiles(algo) if kernel == "conv"
                     else space.compiled_tiles(algo, dt))
            bm, bn, bk = tiles[-1]
            c.put(key, {"blocks": {"bm": bm, "bn": bn, "bk": bk},
                        "us": 1.0}, persist=False)
    tune.reset_stats()


@pytest.mark.parametrize("quantized", [False, True])
def test_block_auto_on_the_lm_path_is_bit_exact(quantized):
    cfg = configs.smoke_config(configs.get_config("minicpm-2b"))
    model = Model(cfg, device="cpu")
    params = model.init(0)
    if quantized:
        from repro_torch.core.quant import attach_quantized_weights
        params = attach_quantized_weights(params)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 20)))

    def logits(block):
        with torch.no_grad(), use_gemm(GemmConfig(
                algo="ffip", impl="cuda", quantized=quantized,
                block=block)):
            cache = model.init_cache(2, 32)
            return model.prefill(params, tokens, cache)[1]

    want = logits(None)
    assert torch.equal(logits("auto"), want)          # misses: the default
    assert tune.stats["hits"] == 0 and tune.stats["misses"] > 0
    _far_tiles()
    got = logits("auto")
    assert tune.stats["misses"] == 0 and tune.stats["hits"] > 0
    assert torch.equal(got, want)


def test_block_auto_on_the_vision_path_is_bit_exact():
    from repro_torch.vision import models as vm
    model = vm.build("alexnet", num_classes=10, image_size=67, width_div=8)
    params = vm.init_params(model, 0, device="cpu")
    x = torch.randn((2, 67, 67, 3), generator=torch.Generator().manual_seed(1))
    q = vm.attach_quantized(model, params)
    for quantized, p in ((False, params), (True, q)):
        tune.reset_stats()
        outs = {}
        for block in (None, "auto", "auto"):
            with torch.no_grad(), use_gemm(GemmConfig(
                    algo="ffip", impl="cuda", quantized=quantized,
                    block=block)):
                outs[block] = vm.apply(model, p, x)
            if block == "auto" and tune.stats["hits"] == 0:
                _far_tiles()
        assert tune.stats["misses"] == 0 and tune.stats["hits"] > 0
        assert torch.equal(outs["auto"], outs[None])
    # a conv's schedule key is the reference's per-image view
    xt = torch.randn((1, 9, 9, 3))
    p = vl.conv_init(torch.Generator().manual_seed(0), 3, 3, 3, 8)
    tune.reset_stats()
    with use_gemm(GemmConfig(algo="fip", impl="cuda", block="auto")):
        vl.conv2d(xt, p, pad=1)
    assert tune._warned_keys == {jtune.conv_key("fip", jnp.float32, 81, 8,
                                                27, 9)}
