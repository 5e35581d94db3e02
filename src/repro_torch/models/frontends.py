"""Modality frontend stubs, counterpart of ``repro/models/frontends.py``.
The audio and vision configs specify the transformer backbone only; these
draw synthetic frame / patch embeddings in place of the real frontends they
stand in for (normal x 0.02 in the config's dtype, from an explicit
``torch.Generator`` on an explicit device). ``Model.prefill(frames=,
patches=)`` and ``Model.loss`` take them; the launchers pass none, as the
reference's do."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def _stub(gen: torch.Generator, shape, cfg: ModelConfig, device):
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * 0.02).to(cfg.dtype)


def audio_frames_stub(gen: torch.Generator, batch: int, cfg: ModelConfig,
                      n_frames: int = 0, *, device) -> torch.Tensor:
    """Whisper: stands in for the 2x conv1d + GELU mel-spectrogram frontend
    (stride-2 conv halves 3000 mel frames to 1500). (batch, n, d_model)."""
    n = n_frames or cfg.encoder.n_frames
    return _stub(gen, (batch, n, cfg.d_model), cfg, device)


def vision_patches_stub(gen: torch.Generator, batch: int, cfg: ModelConfig,
                        n_patches: int = 0, *, device) -> torch.Tensor:
    """Pixtral: stands in for the Pixtral-ViT patch encoder + adapter
    (1024x1024 image -> 16x16 patches -> adapter to backbone d_model).
    (batch, n, d_model)."""
    n = n_patches or cfg.frontend_tokens
    return _stub(gen, (batch, n, cfg.d_model), cfg, device)
