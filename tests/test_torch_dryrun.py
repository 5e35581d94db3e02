"""The port's reports (``repro_torch.launch.{inputs,dryrun,report}``)
against the reference's, on the CPU and the meta device.

* ``inputs``: every arch's params and every supported cell's input tree
  (train batches, prompts, decode tokens, positions and caches), leaf for
  leaf in shape and dtype against the reference's ``jax.eval_shape`` trees
  (their dict keys are the bridge's: the same names on both sides);
* ``dryrun.trace_cell`` + ``analyze`` at full width for minicpm-2b ``decode_32k`` and
  ``train_4k`` and falcon-mamba-7b ``long_500k``: ``model_flops`` equals
  the reference's formula on the reference's config, and the breakdown's
  2-D GEMMs (the dense layers) equal 2 sum(M N K) of the config's dense
  layers (forward; training adds the backward's two);
* ``report``: its table rows equal the reference's on two fixture result
  files (each package's ``RESULTS`` pointed at them), and ``-`` with the
  reason for a null collective term;
* the CLI writes only into ``--out``; a serving and a training cell of
  whisper-small each have one rank's collective term;
* ``served_steps`` traced on meta: the predicted launches of a served
  prefill and decode step, and one rank's collectives at tp 2 on a
  shape-only mesh equal to what each of two connected gloo ranks counts
  on the CPU (minicpm-2b, falcon-mamba-7b, whisper-small, gemma3-4b).
"""
import dataclasses
import json

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import inputs as jinputs
from repro.launch import report as jreport
from repro_torch import configs
from repro_torch.dist import context as dctx
from repro_torch.launch import dryrun, inputs, report
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import Model

import torch_rank_jobs as jobs


def _jax_leaves(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _torch_leaves(tree, prefix="") -> dict:
    if isinstance(tree, torch.Tensor):
        return {prefix: (tuple(tree.shape),
                         str(tree.dtype).replace("torch.", ""))}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    out = {}
    for k, v in items:
        out.update(_torch_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_input_specs_equal_the_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert _torch_leaves(inputs.params_specs_struct(cfg)) == _jax_leaves(
        jinputs.params_specs_struct(jcfg))
    for shape in configs.SHAPES:
        if not configs.shape_supported(cfg, shape)[0]:
            with pytest.raises(ValueError):
                inputs.input_specs(arch, shape.name)
            continue
        _, _, specs = inputs.input_specs(arch, shape.name)
        _, _, want = jinputs.input_specs(arch, shape.name)
        leaves = _torch_leaves(specs)
        assert leaves == _jax_leaves(want), (arch, shape.name)
        assert all(t.device.type == "meta" for t in
                   jax.tree_util.tree_leaves(specs,
                                             is_leaf=torch.is_tensor))


def _dense_mnk(cfg, m: int) -> int:
    """sum(M N K) of a dense LM's or a Mamba1 stack's projections and its
    unembed for M tokens."""
    d, L = cfg.d_model, cfg.n_layers
    if cfg.ssm is not None:
        di = cfg.ssm.expand * d
        r = cfg.ssm.dt_rank or -(-d // 16)
        per = d * 2 * di + di * (r + 2 * cfg.ssm.d_state) + r * di + di * d
    else:
        hd = cfg.hd
        per = (d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
               + cfg.n_heads * hd * d + 3 * d * cfg.d_ff)
    return m * (L * per + d * cfg.vocab)


@pytest.mark.parametrize("arch,shape", [("minicpm-2b", "decode_32k"),
                                        ("minicpm-2b", "train_4k"),
                                        ("falcon-mamba-7b", "long_500k")])
def test_trace_cell_flops(arch, shape):
    r = dryrun.analyze(*dryrun.trace_cell(arch, shape))
    jcfg, s = jconfigs.get_config(arch), jconfigs.SHAPE_BY_NAME[shape]
    n = jcfg.active_param_count()
    tokens = s.global_batch * (1 if s.kind == "decode" else s.seq_len)
    assert r["model_flops"] == (6.0 if s.kind == "train" else 2.0) * n * \
        tokens
    passes = 3 if s.kind == "train" else 1
    assert r["gemm_flops"] == 2 * passes * _dense_mnk(
        configs.get_config(arch), tokens)
    for key in ("hlo_flops", "hlo_bytes", "argument_bytes",
                "peak_live_bytes"):
        assert r[key] > 0, key
    assert r["hlo_flops"] >= r["gemm_flops"]
    # one rank's collectives, a training cell's on the whole mesh
    assert r["collective_s"] is not None
    assert r["collective_counts"]["all-reduce"] > 0
    if s.kind == "train":
        assert r["launches"] == {"flash_fwd": 40, "flash_bwd": 40}


_FIXTURES = {
    "minicpm-2b__decode_32k__16x16.json": dict(
        arch="minicpm-2b", shape="decode_32k", mesh="16x16", status="ok",
        compile_s=1.2, bytes_per_device=3.5e9,
        collective_counts={"all-reduce": 40, "all-gather": 2},
        collective_bytes=5.5e6, compute_s=9e-6, memory_s=8e-3,
        collective_s=4.8e-8, bottleneck="memory_s",
        roofline_fraction=0.0011, useful_flops_ratio=0.3),
    "gemma3-4b__train_4k__16x16.json": dict(
        arch="gemma3-4b", shape="train_4k", mesh="16x16", status="ok",
        compile_s=30.0, bytes_per_device=None, collective_counts={},
        collective_bytes=0.0, compute_s=0.5, memory_s=0.2,
        collective_s=0.3, bottleneck="compute_s", roofline_fraction=1.0,
        useful_flops_ratio=0.9),
    "minicpm-2b__long_500k__16x16.json": dict(
        arch="minicpm-2b", shape="long_500k", mesh="16x16",
        status="skipped", reason="skipped: pure full-attention arch"),
    "whisper-small__prefill_32k__2x16x16.json": dict(
        arch="whisper-small", shape="prefill_32k", mesh="2x16x16",
        status="failed", error="ValueError: frames"),
}


def _rows(text: str) -> list:
    return [line for line in text.splitlines()
            if line.startswith("|") or line.startswith("### mesh")]


def test_report_rows_equal_the_reference(tmp_path, monkeypatch):
    for name, rec in _FIXTURES.items():
        (tmp_path / name).write_text(json.dumps(rec))
    monkeypatch.setattr(jreport, "RESULTS", tmp_path)
    monkeypatch.setattr(report, "RESULTS", tmp_path)
    assert _rows(report.dryrun_section()) == _rows(jreport.dryrun_section())
    assert _rows(report.roofline_section()) == _rows(
        jreport.roofline_section())
    assert report.load(tmp_path, "2x16x16")[0]["status"] == "failed"
    # a null collective term: "-" with its reason
    why = "the port's mesh path does not take this cell"
    rec = dict(_FIXTURES["gemma3-4b__train_4k__16x16.json"],
               collective_s=None, collective_reason=why)
    (tmp_path / "gemma3-4b__train_4k__16x16.json").write_text(
        json.dumps(rec))
    assert f"| - ({why}) |" in report.roofline_section()
    assert report.fmt_bytes(None) == jreport.fmt_bytes(None)
    for x in (3e-7, 2e-3, 0.5):
        assert report.fmt_s(x) == jreport.fmt_s(x)
    assert "§Memory" in report.memory_section()


def test_cli_writes_only_into_out(tmp_path, capsys):
    out = tmp_path / "out"
    assert dryrun.main(["--arch", "minicpm-2b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "whisper-small", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    assert dryrun.main(["--arch", "whisper-small", "--shape", "train_4k",
                        "--out", str(out)]) == 0
    files = sorted(p.name for p in tmp_path.rglob("*") if p.is_file())
    assert files == ["minicpm-2b__long_500k__16x16.json",
                     "whisper-small__decode_32k__16x16.json",
                     "whisper-small__train_4k__16x16.json"]
    # every serving and training cell has one rank's collectives
    for name in files[1:]:
        r = json.loads((out / name).read_text())
        assert r["status"] == "ok" and r["collective_s"] is not None
        assert r["collective_counts"]["all-reduce"] > 0
    assert "OK   whisper-small x decode_32k" in capsys.readouterr().out
    assert report.main(["--dir", str(out)]) == 0


def _smoke(arch: str):
    return configs.smoke_config(configs.get_config(arch))


@pytest.mark.parametrize("quantized", [False, True])
def test_served_steps_predicted_launches(quantized):
    cfg = _smoke("minicpm-2b")
    model = Model(cfg, device="meta")
    steps, state = dryrun.served_steps(model, model.init(0),
                                       quantized=quantized, max_len=32,
                                       prompt_len=8)
    pre = dryrun.predict_dispatch(steps["prefill"], state)
    dec = dryrun.predict_dispatch(steps["decode"], state)
    dense = 7 * cfg.n_layers + 1
    assert pre.launches == {"ffip_gemm_y": dense, "flash_fwd": cfg.n_layers}
    assert dec.launches == {"ffip_gemm_y": dense}
    assert pre.total.bytes > 0 and pre.collectives == []
    assert dryrun.storage_bytes(state[1], 512) % 512 == 0
    views = {"a": state[1]["layers"]["k"], "b": state[1]["layers"]["k"][0]}
    assert dryrun.storage_bytes(views) == dryrun.storage_bytes(views["a"])


def test_one_rank_s_collectives_equal_the_connected_ranks():
    runs = [("minicpm-2b", False), ("minicpm-2b", True),
            ("falcon-mamba-7b", True), ("whisper-small", False),
            ("gemma3-4b", True)]
    job_list = [(jobs.decode_collectives, dict(cfg=_smoke(a), quantized=q))
                for a, q in runs]
    ranks = launch_serve.spawn_ranks(2, job_list, device="cpu",
                                     timeout_s=300)
    mesh = dctx.make_mesh((1, 2), ("data", dctx.MODEL))
    for i, (arch, quantized) in enumerate(runs):
        model = Model(_smoke(arch), device="meta")
        steps, state = dryrun.served_steps(model, model.init(0),
                                           quantized=quantized, mesh=mesh,
                                           max_len=32, prompt_len=8)
        want = dryrun.predict_dispatch(steps["decode"], state).collectives
        assert want and all(kind == "all-reduce" and n == 2
                            for kind, _, n in want)
        for rank in ranks:
            assert rank[i] == want, (arch, quantized)


def test_model_meta_init_draws_nothing_on_a_meta_generator():
    cfg = dataclasses.replace(_smoke("minicpm-2b"), n_layers=1)
    params = Model(cfg, device="meta").init(0)
    assert all(t.device.type == "meta" for t in
               jax.tree_util.tree_leaves(params, is_leaf=torch.is_tensor))
