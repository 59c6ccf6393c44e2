"""Synthetic CSL-like corpus, copied from ``repro.data.corpus``: the same
numpy draws from the same seed give the same documents.

The paper's CSL corpus has 396,209 papers with keyword lists; the
synthetic one keeps its statistical shape (paper Fig. 6): Poisson document
lengths and Zipf term frequencies.
"""
from __future__ import annotations

from typing import List

import numpy as np


def synthetic_csl(n_docs: int, vocab_size: int, *, mean_len: float = 12.0,
                  zipf_a: float = 1.15, seed: int = 0) -> List[List[int]]:
    """Generate tokenised documents (lists of term ids)."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.poisson(mean_len, size=n_docs), 1, None)
    # Zipf-ish categorical over the vocab (term id == rank)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    p = 1.0 / (ranks + 2.7) ** zipf_a
    p /= p.sum()
    docs: List[List[int]] = []
    total = int(lengths.sum())
    draws = rng.choice(vocab_size, size=total, p=p)
    off = 0
    for ln in lengths:
        docs.append(draws[off:off + ln].tolist())
        off += ln
    return docs
