"""Synthetic CSL-like corpus and its statistics, copied from
``repro.data.corpus``: the same numpy draws from the same seed give the
same documents.

The paper's CSL corpus has 396,209 papers with keyword lists; the
synthetic one keeps its statistical shape (paper Fig. 6): Poisson document
lengths and Zipf term frequencies.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class CorpusStats:
    n_docs: int
    vocab_size: int
    mean_doc_len: float
    max_df: int
    median_df: float
    frac_df_below_50: float


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


def corpus_stats(docs: Sequence[Sequence[int]], vocab_size: int) -> CorpusStats:
    df = np.zeros(vocab_size, np.int64)
    lens = np.zeros(len(docs), np.int64)
    for i, d in enumerate(docs):
        u = np.unique(d)
        df[u] += 1
        lens[i] = len(d)
    nz = df[df > 0]
    return CorpusStats(
        n_docs=len(docs),
        vocab_size=vocab_size,
        mean_doc_len=float(lens.mean()),
        max_df=int(df.max()),
        median_df=float(np.median(nz)) if nz.size else 0.0,
        frac_df_below_50=float((nz < 50).mean()) if nz.size else 0.0,
    )
