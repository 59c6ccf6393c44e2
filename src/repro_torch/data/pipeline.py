"""Deterministic synthetic data: numpy copies of
``repro.data.pipeline.lm_batch``, ``recsys_batch`` and
``gnn_synthetic_graph``.  A batch is a pure function of ``(seed, step)``,
a graph of its ``seed``, and each equals the reference's bit for bit."""
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


def gnn_synthetic_graph(n_nodes: int, n_edges: int, d_feat: int,
                        n_classes: int, seed: int = 0,
                        power: float = 1.0) -> Dict[str, np.ndarray]:
    """Random graph with power-law-ish degrees + community-correlated
    labels."""
    rng = np.random.default_rng(seed)
    # preferential-attachment-flavoured endpoints
    w = 1.0 / (np.arange(1, n_nodes + 1) ** power)
    w /= w.sum()
    src = rng.choice(n_nodes, size=n_edges, p=w).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    labels = (rng.integers(0, n_classes, n_nodes)).astype(np.int32)
    x = rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    # make features weakly label-informative
    centers = rng.standard_normal((n_classes, d_feat)).astype(np.float32)
    x += 0.5 * centers[labels]
    return {
        "x": x, "edge_src": src, "edge_dst": dst, "labels": labels,
        "label_mask": np.ones(n_nodes, np.float32),
    }
