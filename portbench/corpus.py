"""The corpus model and the seed pools, drawn from ``--seed``.

A frozen copy of the port's CSL corpus model (``launch/cells.py``:
``csl_term_cdf``, ``csl_draw_terms``, ``csl_docs``), rewritten so that
every number comes from a configuration file: document lengths are
Poisson(``mean_len``) clipped to 1..``max_len``, term ids are drawn from
a Zipf(``zipf_a``) law over ranks shifted by ``zipf_shift`` (id = rank),
repeats within a document kept.  Documents are drawn on the device in a
few large calls and come back as an (n, max_len) int32 block padded with
-1, the layout the program's ``ingest`` takes.

The seed pools are the reference serving bench's
(``chip_smoke.py::_serve_seeds``): head seeds are the most frequent
terms, tail seeds the terms of document frequency ``tail_df[0]`` to
``tail_df[1]``, taken in turns.  Where that bench draws each pool with
replacement, here every member of a pool comes up equally often, in an
order drawn from the seed, so that two seeds offer the same work.
"""
from __future__ import annotations

import hashlib
from typing import Mapping, Sequence

import numpy as np
import torch


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named random stream of a run, so that the
    corpus, the arrivals and the seeds of one ``--seed`` never share draws
    and each stays the same whatever else the run draws."""
    h = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


def term_cdf(vocab: int, corpus: Mapping, device) -> torch.Tensor:
    """The cumulative Zipf law of the term ids, float64 on ``device``."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    p = (ranks + float(corpus["zipf_shift"])) ** -float(corpus["zipf_a"])
    return torch.cumsum(p / p.sum(), 0)


def draw_terms(shape, cdf: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Term ids of ``shape`` drawn from ``cdf`` by inversion, int64."""
    u = torch.rand(shape, generator=gen, dtype=torch.float64,
                   device=cdf.device)
    return torch.searchsorted(cdf, u).clamp_(max=cdf.numel() - 1)


def draw_docs(n_docs: int, vocab: int, corpus: Mapping,
              gen: torch.Generator) -> torch.Tensor:
    """``n_docs`` documents of the corpus model: (n_docs, max_len) int32
    term ids padded with -1, on the generator's device."""
    dev = gen.device
    max_len = int(corpus["max_len"])
    lengths = torch.poisson(
        torch.full((n_docs,), float(corpus["mean_len"]), device=dev,
                   dtype=torch.float32),
        generator=gen).clamp_(1, max_len)
    terms = draw_terms((n_docs, max_len), term_cdf(vocab, corpus, dev), gen)
    pad = torch.arange(max_len, device=dev) >= lengths[:, None]
    return terms.masked_fill_(pad, -1).to(torch.int32)


def doc_freq(docs: torch.Tensor, vocab: int) -> np.ndarray:
    """Document frequency of every term over ``docs`` (repeats in a
    document count once), int64 on the host."""
    d = docs.to(torch.int64)
    n, m = d.shape
    ok = (d >= 0) & (d < vocab)
    rows = torch.arange(n, device=d.device).repeat_interleave(m)
    key = torch.unique(rows[ok.reshape(-1)] * vocab + d[ok])
    return torch.bincount(key % vocab, minlength=vocab).cpu().numpy()


def head_tail_pools(df: np.ndarray, head: int,
                    tail_df: Sequence[int]) -> tuple:
    """(head pool, tail pool): the ``head`` most frequent terms (ties to
    the lower id) and the terms whose document frequency lies in
    ``tail_df`` (both ends included)."""
    head_pool = np.argsort(-df, kind="stable")[:head]
    tail_pool = np.flatnonzero((df >= tail_df[0]) & (df <= tail_df[1]))
    if len(head_pool) == 0 or len(tail_pool) == 0:
        raise ValueError(f"empty seed pool: {len(head_pool)} head terms, "
                         f"{len(tail_pool)} with df in {list(tail_df)}")
    return head_pool, tail_pool


def _balanced(pool: np.ndarray, n: int, r: np.random.Generator) -> np.ndarray:
    """``n`` draws from ``pool`` in which every member comes up as often
    as every other (give or take one), in random order: the same work
    for every seed, in another order."""
    reps = -(-n // len(pool))
    out = np.concatenate([r.permutation(pool) for _ in range(reps)])
    return out[:n]


def head_tail_seeds(df: np.ndarray, n: int, head: int,
                    tail_df: Sequence[int], r: np.random.Generator
                    ) -> np.ndarray:
    """``n`` seeds, head and tail in turns (head first), each pool's
    members drawn equally often in random order."""
    head_pool, tail_pool = head_tail_pools(df, head, tail_df)
    h = _balanced(head_pool, (n + 1) // 2, r)
    t = _balanced(tail_pool, (n + 1) // 2, r)
    return np.stack([h, t], 1).reshape(-1)[:n].astype(np.int64)


def zipf_seeds(n: int, vocab: int, corpus: Mapping,
               gen: torch.Generator) -> np.ndarray:
    """``n`` seeds drawn as the corpus model draws its tokens, so that a
    frequent term is asked for more often (``launch/cells.py::
    _cooc_seeds``)."""
    cdf = term_cdf(vocab, corpus, gen.device)
    return draw_terms((n,), cdf, gen).cpu().numpy().astype(np.int64)
