"""Deterministic synthetic LM data pipeline (a numpy-only copy of
``repro.data.tokens``).

Token streams are a seeded counter-hash — reproducible across hosts without
shared state, sharding-friendly (any (batch, seq) window is addressable), and
non-degenerate (a bigram structure exists so training loss moves).
"""

from __future__ import annotations

import numpy as np


def _mix(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> 16)) * np.uint64(0x45D9F3B)
    x = (x ^ (x >> 16)) * np.uint64(0x45D9F3B)
    return x ^ (x >> 16)


def token_batch(
    *, batch: int, seq: int, vocab: int, seed: int = 0, step: int = 0
) -> np.ndarray:
    """(batch, seq+1) int32 tokens — callers slice input/label windows."""
    rows = np.arange(batch, dtype=np.uint64)[:, None]
    cols = np.arange(seq + 1, dtype=np.uint64)[None, :]
    base = _mix(rows * np.uint64(1_000_003) + np.uint64(seed * 7 + step * 131))
    # bigram-ish structure: token depends on its left neighbor's hash bucket
    raw = _mix(base + cols * np.uint64(2_654_435_761))
    prev = _mix(base + (cols - np.uint64(1)) * np.uint64(2_654_435_761))
    toks = (raw % np.uint64(vocab) + (prev % np.uint64(97))) % np.uint64(vocab)
    return toks.astype(np.int32)


def frontend_embeds(
    *, batch: int, seq: int, d_model: int, seed: int = 0
) -> np.ndarray:
    """Precomputed modality-frontend embeddings (assignment carve-out stub):
    stands in for ViT patch embeddings / EnCodec frame embeddings."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, seq, d_model)) * 0.02).astype(np.float32)
