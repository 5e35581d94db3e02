"""End-to-end training driver on the PyTorch/CUDA port: a ~100M-param LM,
resumable, fault-tolerant, through ``repro_torch`` only.

    PYTHONPATH=src python examples/torch_train_tiny_lm.py --steps 300
    PYTHONPATH=src python examples/torch_train_tiny_lm.py --preset micro \
        --steps 30 --device cpu

The whole substrate: the synthetic data pipeline (prefetch thread), AdamW
with the WSD schedule, the chunked-CE loss (the prompt attention through
K4 and its backward K8 on the card), checkpoint and restart (kill it
mid-run and re-invoke: it resumes from the last checkpoint), the straggler
watchdog and the crash-restart wiring (``--simulate-crash N`` aborts at
step N; the next invocation resumes).
"""
import argparse
import sys

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.step import TrainConfig

PRESETS = {
    # ~100M params: 131k vocab x 512 emb (67M) + 6-layer/512-wide backbone
    "100m": ModelConfig(name="tiny-lm-100m", family="dense", n_layers=6,
                        d_model=512, n_heads=8, n_kv_heads=8, d_ff=1536,
                        vocab=131072, tie_embeddings=True,
                        param_dtype="float32"),
    "micro": ModelConfig(name="tiny-lm-micro", family="dense", n_layers=2,
                         d_model=128, n_heads=4, n_kv_heads=4, d_ff=384,
                         vocab=2048, tie_embeddings=True,
                         param_dtype="float32"),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="100m", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="checkpoints/torch_tiny_lm")
    ap.add_argument("--simulate-crash", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda:0)")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]
    model = build_model(cfg, device=args.device)
    print(f"model {cfg.name}: ~{cfg.param_count() / 1e6:.0f}M params on "
          f"{model.device}")

    crash_at = args.simulate_crash

    def log(m):
        print(f"step {m['data_step']:>5}  loss {m['loss']:.4f}  "
              f"lr {m['lr']:.2e}  |g| {m['grad_norm']:.3f}", flush=True)
        if crash_at and m["data_step"] >= crash_at:
            print("SIMULATED CRASH — rerun to resume from checkpoint")
            sys.exit(42)

    out = train(
        model,
        loop_cfg=LoopConfig(total_steps=args.steps, global_batch=args.batch,
                            seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                            ckpt_every=25, log_every=5),
        train_cfg=TrainConfig(optimizer=AdamWConfig(
            lr=3e-4, schedule="wsd", warmup_steps=20,
            total_steps=args.steps, decay_frac=0.2)),
        log_fn=log,
    )
    losses = [h["loss"] for h in out["history"]]
    print(f"first logged loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    assert losses[-1] < losses[0], "loss should decrease"
    print("OK")


if __name__ == "__main__":
    main()
