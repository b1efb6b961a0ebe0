"""Deterministic, index-addressable synthetic data pipeline.

Every batch is a pure function of (seed, step, shard) — any host can
recompute any other host's shard, which is the substrate for straggler
mitigation and elastic restart (no data-loader state to checkpoint; the
manifest stores only the step counter).

Two sources:
  * `synthetic_lm_batch` — hashed pseudo-random token ids (throughput work);
  * `ByteCorpus` — byte-level language modelling over a real text buffer,
    so the end-to-end example trains on something learnable.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _hash_u32(x: np.ndarray) -> np.ndarray:
    """splitmix-style avalanche over uint32 (vectorised, stateless)."""
    x = x.astype(np.uint64)
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return (z ^ (z >> np.uint64(31))).astype(np.uint32)


def synthetic_lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                       shard: int = 0, n_shards: int = 1) -> np.ndarray:
    """(batch/n_shards, seq+1) int32 tokens — pure function of its arguments."""
    local = batch // n_shards
    idx = (np.uint64(seed) << np.uint64(40)) ^ (np.uint64(step) << np.uint64(20))
    rows = np.arange(local, dtype=np.uint64) + np.uint64(shard * local)
    base = _hash_u32((idx + rows)[:, None] * np.uint64(1000003) +
                     np.arange(seq + 1, dtype=np.uint64)[None, :])
    return (base % np.uint32(vocab)).astype(np.int32)


_DEFAULT_TEXT = (
    "the quick brown fox jumps over the lazy dog. "
    "flash-fhe schedules shallow jobs one per affiliation while deep "
    "bootstrapping pipelines span every cluster. "
) * 512


@dataclasses.dataclass
class ByteCorpus:
    """Byte-level LM over an in-memory buffer with deterministic sampling."""

    text: str = _DEFAULT_TEXT
    vocab: int = 256

    def __post_init__(self):
        self.buf = np.frombuffer(self.text.encode(), dtype=np.uint8)

    def batch(self, seed: int, step: int, batch: int, seq: int,
              shard: int = 0, n_shards: int = 1) -> np.ndarray:
        local = batch // n_shards
        rows = np.arange(local, dtype=np.uint64) + np.uint64(shard * local)
        starts = _hash_u32(np.uint64(seed * 2654435761 + step) + rows) % \
            np.uint32(len(self.buf) - seq - 1)
        out = np.stack([self.buf[s : s + seq + 1] for s in starts.astype(np.int64)])
        return out.astype(np.int32)
