"""Data pipeline: deterministic synthetic LM batches + background prefetch
(the port's own copy of ``repro.training.data``, numpy only: a batch is
bit-equal to the reference's for any (seed, step)).

Stateless batch generation (batch = f(seed, step)) makes restarts exact: on
resume from step k the pipeline replays the same stream with no stored
iterator state.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.common.config import ModelConfig


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, seed: int,
                    step: int) -> Dict[str, np.ndarray]:
    """Zipf-distributed token LM batch (labels = next token)."""
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003)
                                + np.uint64(step))
    out: Dict[str, np.ndarray] = {}
    if cfg.input_mode == "tokens":
        z = rng.zipf(1.3, size=(batch, seq + 1))
        toks = (z % cfg.vocab_size).astype(np.int32)
        out["tokens"] = toks[:, :-1]
        out["labels"] = toks[:, 1:]
    else:
        emb = rng.standard_normal((batch, seq, cfg.d_model),
                                  dtype=np.float32)
        out["embeds"] = emb
        out["labels"] = (rng.integers(
            0, cfg.vocab_size, size=(batch, seq))).astype(np.int32)
    if cfg.vision_tokens:
        out["vision"] = rng.standard_normal(
            (batch, cfg.vision_tokens, cfg.vision_dim), dtype=np.float32)
    return out


class PrefetchLoader:
    """Background-thread prefetch of host batches (overlaps data generation
    with device compute; the same structure would wrap a real tokenized
    shard reader in production)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int,
                 start_step: int = 0, depth: int = 2):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            b = synthetic_batch(self.cfg, self.batch, self.seq, self.seed,
                                step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
