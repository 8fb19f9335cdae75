"""Deterministic synthetic data pipeline with sharded work units.

Work is divided into numbered *shards*; shard -> tokens is a pure function
of (seed, shard_id), which is what makes the CRDT elastic work queue safe:
a shard re-claimed from a dead worker reproduces identical batches, so
duplicated work merges idempotently (runtime/elastic.py).

The host pipeline packs documents to fixed seq_len with next-token targets
and runs a double-buffered prefetch thread.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int            # per-worker batch
    seed: int = 0
    shard_size_batches: int = 8
    mean_doc_len: int = 512


def shard_batches(cfg: DataConfig, shard_id: int) -> list[dict[str, np.ndarray]]:
    """All batches of one shard — pure function of (cfg.seed, shard_id)."""
    rng = np.random.default_rng((cfg.seed << 20) ^ shard_id)
    out = []
    for _ in range(cfg.shard_size_batches):
        toks = _packed_tokens(rng, cfg)
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
            "loss_mask": (toks[:, 1:] != 0).astype(np.float32),
        }
        out.append(batch)
    return out


def _packed_tokens(rng: np.random.Generator, cfg: DataConfig) -> np.ndarray:
    """Pack variable-length 'documents' into [B, seq_len+1] rows.

    Documents are Zipf-ish token streams separated by 1 (BOS); padding is 0.
    """
    b, t = cfg.batch_size, cfg.seq_len + 1
    rows = np.zeros((b, t), np.int64)
    for i in range(b):
        pos = 0
        while pos < t:
            doc_len = min(int(rng.exponential(cfg.mean_doc_len)) + 8, t - pos)
            doc = rng.zipf(1.3, size=doc_len)
            doc = np.clip(doc, 2, cfg.vocab_size - 1)
            rows[i, pos] = 1
            rows[i, pos + 1: pos + doc_len] = doc[: doc_len - 1]
            pos += doc_len
    return rows


class Prefetcher:
    """Background-thread double buffering over a shard iterator."""

    def __init__(self, it: Iterator[dict[str, np.ndarray]], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()

        def worker():
            for item in it:
                self._q.put(item)
            self._q.put(self._done)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def shard_iterator(cfg: DataConfig, shard_ids: Iterator[int]
                   ) -> Iterator[dict[str, np.ndarray]]:
    for sid in shard_ids:
        yield from shard_batches(cfg, sid)
