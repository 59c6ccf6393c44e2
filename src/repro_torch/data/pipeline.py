"""Deterministic synthetic batches: a numpy copy of
``repro.data.pipeline.recsys_batch``.  The batch is a pure function of
``(seed, step)``, and equals the reference's bit for bit."""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import RecSysConfig


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
