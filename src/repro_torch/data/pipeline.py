"""Synthetic deterministic data pipeline: sharded, resumable, double-buffered.
A copy of ``repro/data/pipeline.py`` (host code, numpy only): the same seed
and step give the reference's batches bit for bit.

Design mirrors a production grain/tf.data stack in miniature:
  * deterministic sample -> token mapping (counter-based threefry), so any
    (step, host) pair regenerates identical data — resumability + elastic
    re-sharding need no data checkpoint beyond the step index;
  * per-host sharding: host h of H reads batch rows [h*B/H, (h+1)*B/H);
  * double-buffered background prefetch thread (overlaps host data gen with
    device compute — the §5.1.1 memory-partitioning idea at the host level).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2


class SyntheticLM:
    """Deterministic 'web text' surrogate: structured token streams (zipfian
    unigrams + local repetition) so models actually have something to learn."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_hosts == 0
        self.local_batch = cfg.global_batch // cfg.n_hosts
        # zipfian unigram distribution (stable across processes)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.unigram = (p / p.sum()).astype(np.float64)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        toks = rng.choice(cfg.vocab, size=(self.local_batch, cfg.seq_len + 1),
                          p=self.unigram).astype(np.int32)
        # inject local repetition structure (learnable signal)
        rep = rng.integers(0, cfg.seq_len // 2, size=(self.local_batch,))
        for i, r in enumerate(rep):
            if r > 4:
                toks[i, r:2 * r] = toks[i, :r]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Background thread generating batches ahead of consumption."""

    def __init__(self, ds: SyntheticLM, start_step: int = 0):
        self.ds = ds
        self.q: "queue.Queue" = queue.Queue(maxsize=ds.cfg.prefetch)
        self.step = start_step
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        s = self.step
        while not self._stop.is_set():
            batch = self.ds.batch_at(s)
            while not self._stop.is_set():
                try:
                    self.q.put((s, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.t.join(timeout=2)


def make_pipeline(cfg: ModelConfig, global_batch: int, seq_len: int,
                  *, seed: int = 0, start_step: int = 0,
                  n_hosts: int = 1, host_id: int = 0) -> Prefetcher:
    dcfg = DataConfig(global_batch=global_batch, seq_len=seq_len,
                      vocab=cfg.vocab, seed=seed, n_hosts=n_hosts,
                      host_id=host_id)
    return Prefetcher(SyntheticLM(dcfg), start_step=start_step)
