"""Public model API, counterpart of ``repro/models/model.py``: init, the
training loss (chunked cross-entropy), prefill and decode. The model runs on
the card unless the caller asks for another device (``device=None`` ->
``cuda:0``, raising without a card)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.compat import resolve_device
from repro_torch.models import transformer as T

Tensor = torch.Tensor


def chunked_cross_entropy(params, hidden: Tensor, labels: Tensor,
                          cfg: ModelConfig, *, chunk: int = 512) -> Tensor:
    """Mean cross-entropy over the vocab without (B, S, V) f32 logits at
    once: per sequence chunk of ``chunk`` tokens (the whole S when S is not
    a multiple of it), f32 logits, ``logsumexp - gold``, summed, then
    divided by B * S."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s
    labels = labels.to(torch.long)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        logits = T.logits_fn(params, hidden[:, c0:c0 + chunk],
                             cfg).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[:, c0:c0 + chunk, None])[..., 0]
        total = total + torch.sum(logz - gold)
    return total / (b * s)


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

    def init_paged_cache(self, num_pages: int, page_size: int) -> dict:
        """Shared page pools instead of per-slot rows (see
        transformer.init_paged_cache); sequences address them through a
        (B, max_pages) page table owned by the serving layer."""
        return T.init_paged_cache(self.cfg, num_pages, page_size,
                                  device=self.device)

    # -- training ----------------------------------------------------------
    def loss(self, params, batch: Dict[str, Tensor]) -> Tensor:
        """batch: tokens (B, S), labels (B, S) -> CE + the aux loss (zero
        for the dense and SSM stacks the port carries)."""
        hidden, aux, _ = T.forward(params, batch["tokens"], self.cfg)
        return chunked_cross_entropy(params, hidden, batch["labels"],
                                     self.cfg) + aux

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

    def sample_step(self, params, token: Tensor, cache: dict, pos, *,
                    page_table: Optional[Tensor] = None,
                    paged_impl: str = "gather",
                    write_mask: Optional[Tensor] = None
                    ) -> Tuple[dict, Tensor]:
        """decode_step with greedy sampling on the device: (cache, (B,)
        int32 ids). With ``page_table`` the cache leaves are page pools and
        ``write_mask`` (B,) gates the pool writes: a masked-out slot must not
        touch SHARED pool rows, unlike the harmless private-row rewrite of
        the contiguous path."""
        hidden, _, new_cache = T.forward(
            params, token, self.cfg, caches=cache, cache_pos=pos,
            cache_write_mask=write_mask, page_table=page_table,
            paged_impl=paged_impl)
        return new_cache, T.sample_fn(params, hidden, self.cfg)[:, 0]

    def sample_steps(self, params, token: Tensor, cache: dict, pos: Tensor,
                     live: Tensor, remaining: Tensor, eos_id: Tensor, *,
                     steps: int, page_table: Optional[Tensor] = None,
                     paged_impl: str = "gather") -> Tuple[dict, Tensor]:
        """``steps`` greedy decode steps feeding each sampled token back on
        the device; returns (cache, (steps, B) int32 ids).

        Per-slot freeze, as the reference's scan: a slot that hits EOS or
        exhausts its budget stops advancing its token and position, so each
        later step rewrites the same K/V into the same row and the cache
        stays identical to one-step-at-a-time decode. Paged, a frozen slot
        writes nothing instead (``write_mask=live``): its rows may be
        shared. An SSM state is a running summary, not a row: a frozen
        slot's state goes on changing, which is harmless, since the slot's
        tokens are no longer read and its next admission overwrites the
        whole slot."""
        tok, toks = token, []
        for _ in range(steps):
            cache, nxt = self.sample_step(
                params, tok[:, None], cache, pos, page_table=page_table,
                paged_impl=paged_impl,
                write_mask=live if page_table is not None else None)
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

    def prefill_chunk_paged(self, params, tokens: Tensor, cache: dict,
                            page_table: Tensor, offset: int, valid_len: int,
                            write_start: int, *, paged_impl: str = "gather"
                            ) -> Tuple[dict, Tensor]:
        """One page-aligned prefill chunk of a single sequence into the
        pools. tokens: (1, C) chunk right-padded to the fixed width C;
        page_table: (1, max_pages) this sequence's table; offset: logical
        position of tokens[0, 0]; valid_len: real tokens in the chunk;
        write_start: first logical row to WRITE (rows below it are already in
        the pool as shared prefix pages; a fully shared prompt recomputes
        only its last token and writes nothing). Returns (cache, () int32
        greedy token at the chunk's last valid position, meaningful only on a
        prompt's final chunk).

        Chunking does not change a row's attention: the paged branch attends
        over the whole cache, never a chunk-local window."""
        dev = tokens.device
        rows = offset + torch.arange(tokens.shape[1], device=dev)[None, :]
        wm = (rows >= write_start) & (rows < offset + valid_len)
        hidden, _, new_cache = T.forward(
            params, tokens, self.cfg, caches=cache,
            cache_pos=torch.tensor([offset], dtype=torch.long, device=dev),
            cache_write_mask=wm, is_prefill=True, page_table=page_table,
            paged_impl=paged_impl)
        last = hidden[:, valid_len - 1]                       # (1, d)
        return new_cache, T.sample_fn(params, last[:, None], self.cfg)[0, 0]


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)
