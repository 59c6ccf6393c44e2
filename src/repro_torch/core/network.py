"""CoocNetwork — fixed-shape edge records of a co-occurrence network.

Mirrors ``repro.core.network``: device-side networks are fixed-shape
(padded slots plus a validity mask); the host helpers turn them into the
``{(min, max): weight}`` dict every slice of the port is compared on.  The
fields may be tensors (device results) or numpy arrays (served results).
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


def nodes_of(net: CoocNetwork) -> List[int]:
    ns = set()
    for a, b in to_edge_dict(net):
        ns.add(a)
        ns.add(b)
    return sorted(ns)
