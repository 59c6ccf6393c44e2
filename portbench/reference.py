"""The plain reference of the co-occurrence engine's answers.

Plain PyTorch, on whichever device it is given, written from the paper's
definitions (arXiv:2308.08756, Algorithm 3 and the whole-corpus network)
and independent of the program: it builds its own inverted and forward
index from the generated documents and imports nothing of ``repro_torch``
or of the JAX package.

* **A query** (seed terms, depth, top-k, beam, dedup on) is a level-
  synchronous BFS.  Level 0's frontier is the seeds in their order, each
  row's filter its seed's postings; every seed is visited.  At each level every frontier row counts, over the documents
  of its filter, how many contain each term; the row's own term and every
  visited term are left out; its ``topk`` heaviest terms of positive count
  (ties to the lower term id) are its edges.  After the level every edge
  target is visited.  The next frontier is the level's edges, heaviest
  first (ties in edge order), one per target term (the heaviest), the
  first ``beam`` of them; a row's filter is its parent's filter AND the
  target's postings.  The answer is the list of (source, target, weight)
  edges in level, frontier-row and rank order.
* **A network row** of term t is its ``k`` heaviest co-occurring terms
  over t's postings, t itself left out, ties to the lower id; a slot with
  no positive count is (-1, 0).
* **A cold block** is the postings bitmap of an evicted block of
  documents: document i of the block is bit i % 32 of word row i // 32.

``counts="float16"`` carries every count through float16 (rounded to the
nearest representable value, saturated at its largest): the control of
the correctness check, the precision a tempting faster count would use.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: rows of a count block: (rows x vocab) int64 counts at a time
_COUNT_ELEMS = 1 << 26
#: (row, doc, term) triples expanded at a time
_TRIPLES = 1 << 25
_F16_MAX = 65504.0


class Index:
    """Forward and inverted index of ``docs`` ((N, M) term ids padded
    with -1; document i has id i), on ``docs``' device."""

    def __init__(self, docs: torch.Tensor, vocab: int):
        d = docs.to(torch.int64)
        n, m = d.shape
        self.vocab, self.n_docs, self.device = vocab, n, d.device
        ok = ((d >= 0) & (d < vocab)).reshape(-1)
        rows = torch.arange(n, device=d.device).repeat_interleave(m)
        key = torch.unique(rows[ok] * vocab + d.reshape(-1)[ok])
        fwd_doc = key // vocab
        self.fwd_term = key % vocab                      # by doc, then term
        self.doc_ptr = torch.zeros(n + 1, dtype=torch.int64, device=d.device)
        self.doc_ptr[1:] = torch.cumsum(torch.bincount(fwd_doc, minlength=n),
                                        0)
        pkey = torch.sort(self.fwd_term * n + fwd_doc).values
        self.post_doc = pkey % n                         # by term, then doc
        self.df = torch.bincount(self.fwd_term, minlength=vocab)
        self.term_ptr = torch.zeros(vocab + 1, dtype=torch.int64,
                                    device=d.device)
        self.term_ptr[1:] = torch.cumsum(self.df, 0)

    def postings(self, terms: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(row, doc) pairs: for row r, the documents in [lo[r], hi[r])
        that contain ``terms[r]``, sorted by row, then doc."""
        start, end = self.term_ptr[terms], self.term_ptr[terms + 1]
        row, pos = _ranges(start, end)
        doc = self.post_doc[pos]
        keep = (doc >= lo[row]) & (doc < hi[row])
        return row[keep], doc[keep]

    def triples(self, row: torch.Tensor, doc: torch.Tensor):
        """(row, term) of every term of every (row, doc) pair, in slices
        of at most ``_TRIPLES``: yields (first pair, row, term)."""
        lens = self.doc_ptr[doc + 1] - self.doc_ptr[doc]
        ends = torch.cumsum(lens, 0)
        p0 = 0
        while p0 < len(doc):
            base = int(ends[p0 - 1]) if p0 else 0
            p1 = int(torch.searchsorted(ends, base + _TRIPLES, right=True))
            p1 = max(p1, p0 + 1)
            r, pos = _ranges(self.doc_ptr[doc[p0:p1]],
                             self.doc_ptr[doc[p0:p1] + 1])
            yield p0, row[p0:p1][r], self.fwd_term[pos], r + p0
            p0 = p1


def _ranges(start: torch.Tensor, end: torch.Tensor):
    """For ranges [start[i], end[i]): (i, position) of every position."""
    lens = (end - start).clamp(min=0)
    idx = torch.repeat_interleave(torch.arange(len(start),
                                               device=start.device), lens)
    first = torch.cumsum(lens, 0) - lens
    return idx, start[idx] + torch.arange(int(lens.sum()),
                                          device=start.device) - first[idx]


def _counts(index: Index, row: torch.Tensor, doc: torch.Tensor, r0: int,
            r1: int, precision: str) -> torch.Tensor:
    """(r1 - r0, V) counts of rows [r0, r1) over their (row, doc) pairs."""
    v = index.vocab
    out = torch.zeros((r1 - r0) * v, dtype=torch.int64, device=index.device)
    sel = (row >= r0) & (row < r1)
    for _, r, t, _ in index.triples(row[sel], doc[sel]):
        out += torch.bincount((r - r0) * v + t, minlength=(r1 - r0) * v)
    out = out.reshape(r1 - r0, v)
    if precision == "float16":
        out = out.to(torch.float32).clamp_(max=_F16_MAX).to(
            torch.float16).to(torch.int64)
    elif precision != "int32":
        raise ValueError(f"unknown count precision {precision!r}")
    return out


def _top(counts: torch.Tensor, k: int):
    """The ``k`` heaviest columns of each row, ties to the lower column:
    (weights, ids) on the host, weight <= 0 marking no edge."""
    order = torch.sort(-counts, dim=1, stable=True).indices[:, :k]
    return (torch.gather(counts, 1, order).cpu().numpy(),
            order.cpu().numpy())


class Level:
    """One level's frontier: rows of (query, term) and their filters as
    (row, doc) pairs."""

    def __init__(self, query, term, row, doc):
        self.query, self.term, self.row, self.doc = query, term, row, doc


def bfs(index: Index, seeds: Sequence, *, depth: int, topk: int,
        beam: int, lo: Optional[Sequence[int]] = None,
        hi: Optional[Sequence[int]] = None, precision: str = "int32",
        stats: Optional[List[Dict]] = None, groups=None,
        word_of=None) -> List[List[Tuple[int, int, int]]]:
    """The answer of each query: a list of (src, dst, weight).  A query
    is a sequence of seed terms, or one seed term.  ``lo``/``hi`` bound
    each query's documents (default: all).

    With ``stats`` (a list), one dict per (group, level) is appended: the
    frontier rows with a nonempty filter, the nonzero packed words over
    those rows and the packed words any of them selects, where
    ``word_of(doc)`` is a document's packed word row and ``groups`` names
    each query's group (a served batch)."""
    dev = index.device
    queries = [[int(x) for x in np.atleast_1d(s)] for s in seeds]
    q = len(queries)
    of = np.asarray([qi for qi, s in enumerate(queries) for _ in s],
                    np.int64)
    terms = np.asarray([t for s in queries for t in s], np.int64)
    lo_q = np.asarray(lo if lo is not None else [0] * q, np.int64)
    hi_q = np.asarray(hi if hi is not None else [index.n_docs] * q,
                      np.int64)
    row, doc = index.postings(torch.as_tensor(terms, device=dev),
                              torch.as_tensor(lo_q[of], device=dev),
                              torch.as_tensor(hi_q[of], device=dev))
    lvl = Level(of, terms, row, doc)
    visited = [set(s) for s in queries]
    edges: List[List[Tuple[int, int, int]]] = [[] for _ in range(q)]
    max_rows = max(1, _COUNT_ELEMS // index.vocab)
    for level in range(depth):
        n_rows = len(lvl.term)
        if stats is not None:
            _level_stats(stats, level, lvl, groups, word_of)
        w_all = np.zeros((n_rows, topk), np.int64)
        i_all = np.zeros((n_rows, topk), np.int64)
        for r0 in range(0, n_rows, max_rows):
            r1 = min(n_rows, r0 + max_rows)
            c = _counts(index, lvl.row, lvl.doc, r0, r1, precision)
            ar = torch.arange(r1 - r0, device=dev)
            c[ar, torch.as_tensor(lvl.term[r0:r1], device=dev)] = -1
            rq, rc = [], []
            for r in range(r0, r1):
                vis = visited[lvl.query[r]]
                rq += [r - r0] * len(vis)
                rc += list(vis)
            c[torch.as_tensor(rq, dtype=torch.int64, device=dev),
              torch.as_tensor(rc, dtype=torch.int64, device=dev)] = -1
            w_all[r0:r1], i_all[r0:r1] = _top(c, topk)
        # per query: the level's edges, then its next frontier
        cand: List[List[Tuple[int, int, int]]] = [[] for _ in range(q)]
        for r in range(n_rows):
            qi, src = lvl.query[r], int(lvl.term[r])
            for w, t in zip(w_all[r], i_all[r]):
                if w > 0:
                    edges[qi].append((src, int(t), int(w)))
                    cand[qi].append((int(w), r, int(t)))
        if level + 1 == depth:
            break
        nq, nt, parents = [], [], []
        for qi in range(q):
            visited[qi] |= {t for _, _, t in cand[qi]}
            seen, picked = set(), []
            for w, r, t in sorted(cand[qi], key=lambda c: -c[0]):
                if t not in seen:
                    seen.add(t)
                    picked.append((r, t))
            for r, t in picked[:beam]:
                nq.append(qi)
                nt.append(t)
                parents.append(r)
        lvl = _children(index, lvl, np.asarray(nq, np.int64),
                        np.asarray(nt, np.int64), np.asarray(parents,
                                                             np.int64))
    return edges


def _children(index: Index, lvl: Level, nq, nt, parents) -> Level:
    """The next frontier: child c's filter is its parent row's documents
    that contain term ``nt[c]``."""
    dev, v = index.device, index.vocab
    if len(nt) == 0:
        e = torch.zeros(0, dtype=torch.int64, device=dev)
        return Level(nq, nt, e, e)
    key = torch.as_tensor(parents * v + nt, device=dev)
    order = torch.argsort(key)
    skey = key[order]
    rows, docs = [], []
    for p0, r, t, pair in index.triples(lvl.row, lvl.doc):
        k = r * v + t
        pos = torch.searchsorted(skey, k).clamp_(max=len(skey) - 1)
        hit = skey[pos] == k
        rows.append(order[pos[hit]])
        docs.append(lvl.doc[pair[hit]])
    row = torch.cat(rows)
    doc = torch.cat(docs)
    o = torch.argsort(row * index.n_docs + doc)
    return Level(nq, nt, row[o], doc[o])


def _level_stats(stats, level, lvl: Level, groups, word_of) -> None:
    """Append one dict per group for this level's frontier: its rows with
    a nonempty filter, their nonzero (row, word) pairs, and the distinct
    words they select."""
    groups = np.asarray(groups, np.int64)
    dev = lvl.row.device
    ng = int(groups.max()) + 1
    g_of_row = torch.as_tensor(groups[lvl.query], dtype=torch.int64,
                               device=dev)
    word = word_of(lvl.doc)
    n_w = int(word.max()) + 1 if len(word) else 1
    rw = torch.unique(lvl.row * n_w + word)
    gw = torch.unique(g_of_row[lvl.row] * n_w + word)
    per = {"rows": torch.bincount(g_of_row[torch.unique(lvl.row)],
                                  minlength=ng),
           "nonzero_words": torch.bincount(g_of_row[rw // n_w],
                                           minlength=ng),
           "active_words": torch.bincount(gw // n_w, minlength=ng)}
    per = {k: x.cpu().numpy() for k, x in per.items()}
    for gi in np.unique(groups):
        stats.append({"group": int(gi), "level": level,
                      **{k: int(x[gi]) for k, x in per.items()}})


def network_rows(index: Index, terms: Sequence[int], k: int, *,
                 precision: str = "int32") -> Tuple[np.ndarray, np.ndarray]:
    """Rows of the whole network for ``terms``: (dst, weight), both
    (len(terms), k) int64, an empty slot (-1, 0)."""
    dev = index.device
    t = torch.as_tensor(list(terms), dtype=torch.int64, device=dev)
    n = len(terms)
    row, doc = index.postings(t, torch.zeros(n, dtype=torch.int64, device=dev),
                              torch.full((n,), index.n_docs,
                                         dtype=torch.int64, device=dev))
    dst = np.zeros((n, k), np.int64)
    wt = np.zeros((n, k), np.int64)
    step = max(1, _COUNT_ELEMS // index.vocab)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        c = _counts(index, row, doc, r0, r1, precision)
        c[torch.arange(r1 - r0, device=dev), t[r0:r1]] = -1
        w, i = _top(c, k)
        ok = w > 0
        dst[r0:r1] = np.where(ok, i, -1)
        wt[r0:r1] = np.where(ok, w, 0)
    return dst, wt


def network_work(index: Index, word_of) -> Dict[str, int]:
    """What the whole network needs of the packed postings: the terms
    with postings, their nonzero (term, word) pairs, the packed words."""
    term = torch.repeat_interleave(torch.arange(index.vocab,
                                                device=index.device),
                                   index.df)
    word = word_of(index.post_doc)
    n_w = int(word.max()) + 1 if len(word) else 1
    return {"rows": int((index.df > 0).sum()),
            "nonzero_words": int(torch.unique(term * n_w + word).numel()),
            "words": n_w}


def cold_block(docs: torch.Tensor, vocab: int) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """The postings bitmap of one block of documents, (ceil(n / 32),
    vocab) uint32, and its (vocab,) document frequencies."""
    d = docs.to(torch.int64)
    n, m = d.shape
    ok = ((d >= 0) & (d < vocab)).reshape(-1)
    rows = torch.arange(n, device=d.device).repeat_interleave(m)
    key = torch.unique(rows[ok] * vocab + d.reshape(-1)[ok])
    i, t = key // vocab, key % vocab
    words = torch.zeros(((n + 31) // 32) * vocab, dtype=torch.int64,
                        device=d.device)
    # distinct bits of one word: their sum is their OR
    words.index_add_(0, (i // 32) * vocab + t, torch.ones_like(i) << (i % 32))
    df = torch.bincount(t, minlength=vocab)
    return (words.reshape(-1, vocab).cpu().numpy().astype(np.uint32),
            df.cpu().numpy())
