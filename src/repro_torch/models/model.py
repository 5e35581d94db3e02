"""Public model API for serving, counterpart of ``repro/models/model.py``:
init / prefill / decode. The model runs on the card unless the caller asks
for another device (``device=None`` -> ``cuda:0``, raising without a card)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.compat import resolve_device
from repro_torch.models import transformer as T

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: Optional[torch.device] = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    # -- init ------------------------------------------------------------
    def init(self, seed: int = 0) -> dict:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return T.init_params(gen, self.cfg, device=self.device)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return T.init_cache(self.cfg, batch, max_len, device=self.device)

    # -- serving -----------------------------------------------------------
    def prefill(self, params, tokens: Tensor, cache: dict
                ) -> Tuple[dict, Tensor]:
        """Fill the cache with a prompt; returns (cache, last-token logits)."""
        hidden, _, new_cache = T.forward(
            params, tokens, self.cfg, caches=cache, cache_pos=0,
            is_prefill=True)
        logits = T.logits_fn(params, hidden[:, -1:], self.cfg)
        return new_cache, logits[:, 0]

    def decode_step(self, params, token: Tensor, cache: dict, pos
                    ) -> Tuple[dict, Tensor]:
        """One decode step. token: (B, 1); pos: scalar or (B,) per-slot
        count of cached tokens (row i writes its K/V at pos[i], applies rope
        at pos[i] and attends rows < pos[i] + 1)."""
        hidden, _, new_cache = T.forward(params, token, self.cfg,
                                         caches=cache, cache_pos=pos)
        return new_cache, T.logits_fn(params, hidden, self.cfg)[:, 0]

    def sample_step(self, params, token: Tensor, cache: dict, pos
                    ) -> Tuple[dict, Tensor]:
        """decode_step with greedy sampling on the device: (cache, (B,)
        int32 ids)."""
        hidden, _, new_cache = T.forward(params, token, self.cfg,
                                         caches=cache, cache_pos=pos)
        return new_cache, T.sample_fn(params, hidden, self.cfg)[:, 0]

    def sample_steps(self, params, token: Tensor, cache: dict, pos: Tensor,
                     live: Tensor, remaining: Tensor, eos_id: Tensor, *,
                     steps: int) -> Tuple[dict, Tensor]:
        """``steps`` greedy decode steps feeding each sampled token back on
        the device; returns (cache, (steps, B) int32 ids).

        Per-slot freeze, as the reference's scan: a slot that hits EOS or
        exhausts its budget stops advancing its token and position, so each
        later step rewrites the same K/V into the same row and the cache
        stays identical to one-step-at-a-time decode."""
        tok, toks = token, []
        for _ in range(steps):
            cache, nxt = self.sample_step(params, tok[:, None], cache, pos)
            remaining = torch.where(live, remaining - 1, remaining)
            finished = live & ((nxt == eos_id) | (remaining <= 0))
            live = live & ~finished
            pos = torch.where(live, pos + 1, pos)
            tok = torch.where(live, nxt, tok)
            toks.append(nxt)
        return cache, torch.stack(toks)

    def prefill_sample(self, params, tokens: Tensor, cache: dict,
                       lengths: Tensor, slot_mask: Tensor
                       ) -> Tuple[dict, Tensor]:
        """Bucketed batched prefill into the shared slot cache. tokens:
        (B, L) right-padded prompts; lengths: (B,); slot_mask: (B,) bool rows
        being admitted (the others keep their cache rows). Returns (cache,
        (B,) int32 first token, argmax at each row's own last position)."""
        b = tokens.shape[0]
        hidden, _, new_cache = T.forward(
            params, tokens, self.cfg, caches=cache, cache_pos=0,
            cache_write_mask=slot_mask, is_prefill=True)
        last = hidden[torch.arange(b, device=hidden.device), lengths - 1]
        return new_cache, T.sample_fn(params, last[:, None], self.cfg)[:, 0]


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)
