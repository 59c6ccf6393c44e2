"""Deterministic synthetic batches: numpy copies of
``repro.data.pipeline.lm_batch`` and ``recsys_batch``.  A batch is a pure
function of ``(seed, step)``, and equals the reference's bit for bit."""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import LMConfig, RecSysConfig


def lm_batch(cfg: LMConfig, batch: int, seq: int, step: int,
             seed: int = 0) -> Dict[str, np.ndarray]:
    """Zipf-distributed synthetic token stream (stable per (seed, step))."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    p = 1.0 / (ranks + 2.7) ** 1.05
    p /= p.sum()
    toks = rng.choice(cfg.vocab_size, size=(batch, seq + 1),
                      p=p).astype(np.int32)
    return {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:],
        "mask": np.ones((batch, seq), np.float32),
    }


def recsys_batch(cfg: RecSysConfig, batch: int, step: int,
                 seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    if cfg.interaction in ("fm", "dot"):
        out = {
            "sparse_ids": rng.integers(0, cfg.vocab_per_field,
                                       (batch, cfg.n_sparse)).astype(np.int32),
            "labels": (rng.random(batch) < 0.25).astype(np.int32),
        }
        if cfg.n_dense:
            out["dense"] = rng.standard_normal(
                (batch, cfg.n_dense)).astype(np.float32)
        return out
    s = cfg.seq_len
    return {
        "seq": rng.integers(0, cfg.n_items, (batch, s)).astype(np.int32),
        "pos": rng.integers(0, cfg.n_items, (batch, s)).astype(np.int32),
        "neg": rng.integers(0, cfg.n_items, (batch, s)).astype(np.int32),
        "mask": np.ones((batch, s), np.float32),
    }
