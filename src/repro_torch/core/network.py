"""CoocNetwork — fixed-shape edge records of a co-occurrence network.

Mirrors ``repro.core.network``: device-side networks are fixed-shape
(padded slots plus a validity mask); the host helpers turn them into the
``{(min, max): weight}`` dict every slice of the port is compared on, and
the whole-network statistics (``global_statistics``, ``degree_histogram``,
``edge_jaccard``), host numpy code copied from the reference.  The fields
may be tensors (device results) or numpy arrays (served results).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import topk_lower_index


class CoocNetwork(NamedTuple):
    src: torch.Tensor     # (N,) int32
    dst: torch.Tensor     # (N,) int32
    weight: torch.Tensor  # (N,) int32 (0 for invalid slots)
    valid: torch.Tensor   # (N,) bool

    @property
    def max_edges(self) -> int:
        return self.src.shape[0]

    def num_edges(self) -> int:
        return int(_np(self.valid).astype(bool).sum())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def canonical_pairs(net: CoocNetwork) -> Tuple[torch.Tensor, torch.Tensor]:
    """Undirected canonical (min, max) pairs; invalid slots -> (-1, -1)."""
    a = torch.minimum(net.src, net.dst)
    b = torch.maximum(net.src, net.dst)
    return torch.where(net.valid, a, -1), torch.where(net.valid, b, -1)


def merge_duplicates(net: CoocNetwork, vocab_size: int) -> CoocNetwork:
    """Merge duplicate undirected edges (weight = max over duplicates):
    sort by canonical pair, segment-reduce, keep the first of each run."""
    a, b = canonical_pairs(net)
    n = net.max_edges
    v = int(vocab_size)
    key = torch.where(net.valid, a.to(torch.int64) * v + b, v * v)
    order = torch.sort(key, stable=True).indices
    a_s, b_s, v_s = a[order], b[order], net.valid[order]
    first = torch.ones_like(v_s)
    first[1:] = (a_s[1:] != a_s[:-1]) | (b_s[1:] != b_s[:-1])
    first &= v_s
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    w_s = torch.where(v_s, net.weight[order], 0)
    wmax = torch.zeros(n, dtype=net.weight.dtype, device=w_s.device)
    wmax = wmax.scatter_reduce(0, torch.where(v_s, seg, n - 1), w_s, "amax",
                               include_self=False)
    return CoocNetwork(
        src=torch.where(first, a_s, -1),
        dst=torch.where(first, b_s, -1),
        weight=torch.where(first, wmax[seg.clamp(min=0)], 0),
        valid=first,
    )


def top_edges(net: CoocNetwork, limit: int) -> CoocNetwork:
    """The paper's visualisation 'limit': keep the `limit` heaviest edges
    (``lax.top_k`` order: equal weights, lower slot first)."""
    w = torch.where(net.valid, net.weight, -1)
    _, idx = topk_lower_index(w, min(limit, net.max_edges))
    return CoocNetwork(net.src[idx], net.dst[idx], net.weight[idx],
                       net.valid[idx])


def to_edge_dict(net: CoocNetwork) -> Dict[Tuple[int, int], int]:
    """Host dict {(min, max): weight}; duplicates keep the max weight."""
    ok = _np(net.valid).astype(bool)
    if not ok.any():
        return {}
    src = _np(net.src)[ok].astype(np.int64)
    dst = _np(net.dst)[ok].astype(np.int64)
    w = _np(net.weight)[ok].astype(np.int64)
    a = np.minimum(src, dst)
    b = np.maximum(src, dst)
    # sort by (a, b, -w): the first row of each (a, b) run carries max weight
    order = np.lexsort((-w, b, a))
    a, b, w = a[order], b[order], w[order]
    first = np.ones(len(a), bool)
    first[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    return dict(zip(zip(a[first].tolist(), b[first].tolist()),
                    w[first].tolist()))


def edge_jaccard(n1: CoocNetwork, n2: CoocNetwork) -> float:
    """Jaccard similarity of undirected edge sets (depth-insensitivity metric,
    paper §3.2 / Fig. 5)."""
    e1 = set(to_edge_dict(n1))
    e2 = set(to_edge_dict(n2))
    if not e1 and not e2:
        return 1.0
    return len(e1 & e2) / max(1, len(e1 | e2))


def to_edge_index(net: CoocNetwork) -> Tuple[np.ndarray, np.ndarray]:
    """(2, E) int32 undirected edge index + (E,) weights, symmetrised."""
    d = to_edge_dict(net)
    if not d:
        return np.zeros((2, 0), np.int32), np.zeros((0,), np.int32)
    pairs = np.array(sorted(d), dtype=np.int32).T
    w = np.array([d[tuple(p)] for p in pairs.T], dtype=np.int32)
    ei = np.concatenate([pairs, pairs[::-1]], axis=1)
    ew = np.concatenate([w, w])
    return ei, ew


class NetworkStats(NamedTuple):
    """Global (whole-network) statistics — the figures the paper's
    downstream consumers report (degree distribution, density; Margan et
    al., PAPERS.md).  Degrees are over the UNIQUE undirected edge set."""

    n_nodes: int                 # terms with >= 1 incident edge
    n_edges: int                 # unique undirected edges
    density: float               # 2E / (N (N - 1))
    mean_degree: float           # 2E / N
    max_degree: int
    mean_weighted_degree: float  # mean over connected nodes
    max_weight: int              # heaviest edge
    total_weight: int            # sum of unique undirected edge weights
    degree: np.ndarray           # (vocab,) int64 per-term degree
    weighted_degree: np.ndarray  # (vocab,) int64 per-term weight sum


def global_statistics(net: CoocNetwork, vocab_size: int) -> NetworkStats:
    """Compute :class:`NetworkStats` for ``net`` (host-side, vectorised).

    Edges are canonicalised + deduped first (``to_edge_dict`` semantics),
    so a materialized top-k network — where (a, b) and (b, a) both appear
    when each is in the other's top-k — counts every undirected edge once.
    """
    d = to_edge_dict(net)
    deg = np.zeros((vocab_size,), np.int64)
    wdeg = np.zeros((vocab_size,), np.int64)
    if d:
        pairs = np.array(list(d.keys()), np.int64)        # (E, 2)
        w = np.array(list(d.values()), np.int64)          # (E,)
        np.add.at(deg, pairs[:, 0], 1)
        np.add.at(deg, pairs[:, 1], 1)
        np.add.at(wdeg, pairs[:, 0], w)
        np.add.at(wdeg, pairs[:, 1], w)
    n = int((deg > 0).sum())
    e = len(d)
    return NetworkStats(
        n_nodes=n,
        n_edges=e,
        density=(2.0 * e / (n * (n - 1))) if n > 1 else 0.0,
        mean_degree=(2.0 * e / n) if n else 0.0,
        max_degree=int(deg.max()) if n else 0,
        mean_weighted_degree=(float(wdeg[deg > 0].mean()) if n else 0.0),
        max_weight=int(max(d.values())) if d else 0,
        total_weight=int(sum(d.values())),
        degree=deg,
        weighted_degree=wdeg,
    )


def degree_histogram(stats: NetworkStats) -> np.ndarray:
    """h[g] = #connected nodes with degree g (the degree-distribution
    figure); h[0] counts nothing (isolated terms are not nodes)."""
    deg = stats.degree[stats.degree > 0]
    if deg.size == 0:
        return np.zeros((1,), np.int64)
    h = np.bincount(deg)
    h[0] = 0
    return h


def nodes_of(net: CoocNetwork) -> List[int]:
    ns = set()
    for a, b in to_edge_dict(net):
        ns.add(a)
        ns.add(b)
    return sorted(ns)
