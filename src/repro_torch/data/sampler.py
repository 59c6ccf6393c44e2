"""Layered neighbour sampler (GraphSAGE-style) for minibatch GNN work: a
numpy copy of ``repro.data.sampler``.

Per layer it draws ``fanout`` neighbours of each frontier node, uniformly
and with replacement, from an in-edge CSR adjacency.  The output is a
fixed-shape padded subgraph (``edge_src`` / ``edge_dst`` in
subgraph-local ids, with ``edge_mask``), so one shape serves every batch.
Given the same ``np.random.Generator`` the output equals the reference's
bit for bit: the same draws in the same order, the same local-id order
and the same padding.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def build_csr(edge_src: np.ndarray, edge_dst: np.ndarray, n_nodes: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """In-edge CSR: for each dst node, the list of its src neighbours
    (``indptr`` (n_nodes + 1,) int64, ``indices`` in edge order)."""
    order = np.argsort(edge_dst, kind="stable")
    sorted_src = edge_src[order]
    counts = np.bincount(edge_dst, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, sorted_src


def sample_subgraph(indptr: np.ndarray, indices: np.ndarray,
                    seeds: np.ndarray, fanouts: Sequence[int],
                    rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Sample a layered subgraph.  Returns fixed-shape padded arrays:

      nodes      (N_max,)  global ids of subgraph nodes (seeds first)
      node_mask  (N_max,)
      edge_src   (E_max,)  local ids
      edge_dst   (E_max,)  local ids
      edge_mask  (E_max,)
      n_seeds    int

    N_max / E_max are the worst-case sizes implied by (len(seeds),
    fanouts) (:func:`subgraph_sizes`), so shapes are static per
    configuration.
    """
    n_seeds = len(seeds)
    n_max, e_max = subgraph_sizes(n_seeds, fanouts)

    node_ids: list = list(seeds)
    local_of = {int(g): i for i, g in enumerate(seeds)}
    es, ed = [], []
    frontier = list(seeds)
    for f in fanouts:
        nxt = []
        for g in frontier:
            lo, hi = indptr[g], indptr[g + 1]
            if hi == lo:
                continue
            take = rng.integers(lo, hi, size=f)  # f samples with replacement
            for t in indices[take]:
                t = int(t)
                if t not in local_of:
                    local_of[t] = len(node_ids)
                    node_ids.append(t)
                    nxt.append(t)
                es.append(local_of[t])
                ed.append(local_of[int(g)])
        frontier = nxt

    nodes = np.full(n_max, 0, np.int64)
    nodes[:len(node_ids)] = node_ids
    node_mask = np.zeros(n_max, np.float32)
    node_mask[:len(node_ids)] = 1.0
    edge_src = np.zeros(e_max, np.int32)
    edge_dst = np.zeros(e_max, np.int32)
    edge_mask = np.zeros(e_max, np.float32)
    edge_src[:len(es)] = es
    edge_dst[:len(ed)] = ed
    edge_mask[:len(es)] = 1.0
    return {
        "nodes": nodes, "node_mask": node_mask,
        "edge_src": edge_src, "edge_dst": edge_dst, "edge_mask": edge_mask,
        "n_seeds": n_seeds,
    }


def subgraph_sizes(batch_nodes: int, fanouts: Sequence[int]
                   ) -> Tuple[int, int]:
    """(N_max, E_max) for the fixed-shape contract."""
    n_max = batch_nodes
    e_max = 0
    layer = batch_nodes
    for f in fanouts:
        e_max += layer * f
        layer = layer * f
        n_max += layer
    return n_max, e_max
