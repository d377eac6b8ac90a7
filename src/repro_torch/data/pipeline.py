"""Deterministic, resumable, step-indexed data pipeline (a numpy copy of
``repro/data/pipeline.py``; ``batch_at`` gives the reference's bytes).

  * Step-indexed determinism: batch(step) is a pure function of (seed,
    step), so a job restarted from checkpoint step N regenerates the same
    batches with no pipeline state to persist, and any host can produce
    any shard.
  * Host sharding: each host makes only its slice of the global batch.
  * Prefetch: a bounded background thread keeps ``prefetch`` batches
    ready.

The stream is synthetic: hashed-counter tokens with a Zipf-like skew (so
MoE routing sees an imbalance), and for whisper standard-normal encoder
frame embeddings.  A real tokenised corpus would replace only
``_tokens_for_index``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    enc_frames: int = 0       # > 0: also emit encoder frame embeddings
    d_model: int = 0
    zipf_a: float = 1.3


class Pipeline:
    """Deterministic synthetic stream; ``batch_at(step)`` is pure."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {n_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts

    def _tokens_for_index(self, idx: np.ndarray) -> np.ndarray:
        """(B,) sample indices → (B, S+1) token rows: a Philox stream per
        row, keyed by the seed, counter the sample index."""
        cfg = self.cfg
        S = cfg.seq_len + 1
        rows = []
        for i in idx:
            rng = np.random.Generator(np.random.Philox(key=cfg.seed,
                                                       counter=int(i)))
            toks = (cfg.vocab * rng.random(S) ** cfg.zipf_a).astype(np.int32)
            rows.append(np.clip(toks, 0, cfg.vocab - 1))
        return np.stack(rows)

    def batch_at(self, step: int) -> dict:
        """This host's slice of global batch ``step``: tokens (B, S) and
        the next-token labels (B, S) int32 [, enc_frames (B, F, D) f32]."""
        cfg = self.cfg
        base = step * cfg.global_batch + self.host_id * self.local_batch
        idx = np.arange(base, base + self.local_batch, dtype=np.int64)
        toks = self._tokens_for_index(idx)
        batch = {"tokens": toks[:, :-1],
                 "labels": toks[:, 1:].astype(np.int32)}
        if cfg.enc_frames:
            rng = np.random.Generator(np.random.Philox(key=cfg.seed + 1,
                                                       counter=step))
            batch["enc_frames"] = rng.standard_normal(
                (self.local_batch, cfg.enc_frames, cfg.d_model),
                dtype=np.float32)
        return batch

    def iterate(self, start_step: int = 0, prefetch: int = 2
                ) -> Iterator[dict]:
        """Prefetching iterator from ``start_step``; closing it stops the
        producer thread."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            s = start_step
            while not stop.is_set():
                item = (s, self.batch_at(s))
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                s += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()[1]
        finally:
            stop.set()
            t.join(timeout=5)
