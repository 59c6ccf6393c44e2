"""Co-occurrence network construction (the paper's Algorithm 3), in PyTorch.

Mirrors ``repro.core.cooccurrence``:

* the numpy host oracles ``traversal_construct_host`` (Algorithm 1),
  ``recursive_construct_host`` (Algorithm 2), ``bfs_construct_host``
  (Algorithm 3 on a dense incidence), ``build_host_index`` and
  ``bfs_construct_host_fast`` (Algorithm 3 as a search engine runs it on a
  CPU), copied, and ``traversal_construct_dense``, the traversal baseline
  as one ``X^T X`` product in torch;
* ``bfs_construct_batch``: the level-synchronous beam BFS over the packed
  index, written batch-major — the frontier of Q queries is one (Q*B, W)
  mask block and the visited sets one (Q, V) block, where the reference
  ``jax.vmap``s a single-query BFS.  Results are bit-identical to it,
  values and tie order.  With a mesh (``mesh=``, or the context's) each
  level runs term- or doc-sharded (:mod:`repro_torch.core.distributed`),
  bit-identical to the single-device level.

Edge semantics (paper §3): an edge (a, b, w) means "term b is one of the
top-k most frequent terms among documents matching the filter path ending
at a", with w that document count.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.inverted_index import PackedIndex, dense_operand
from repro_torch.core.network import CoocNetwork
from repro_torch.kernels.ref import topk_lower_index

# ---------------------------------------------------------------------------
# Host oracles (numpy), copied from the reference
# ---------------------------------------------------------------------------


def traversal_construct_host(doc_terms: Sequence[Sequence[int]],
                             vocab_size: int) -> Dict[Tuple[int, int], int]:
    """Paper Algorithm 1: iterate documents, enumerate term pairs, count.
    Returns {(min(a,b), max(a,b)): count}; a pair counts once per doc."""
    counts: Dict[Tuple[int, int], int] = {}
    for terms in doc_terms:
        uniq = sorted(set(int(t) for t in terms if 0 <= int(t) < vocab_size))
        for i, a in enumerate(uniq):
            for b in uniq[i + 1:]:
                counts[(a, b)] = counts.get((a, b), 0) + 1
    return counts


def traversal_construct_dense(x: torch.Tensor) -> torch.Tensor:
    """The traversal baseline as one product: C = X^T X over the dense
    incidence.  x: (D, V) 0/1 incidence of any dtype.  Returns (V, V)
    float32 with C[v, v] = df(v) on the diagonal; the off-diagonal entries
    are exact pair co-occurrence counts for D < 2^24."""
    xf = x.to(torch.float32)
    return xf.t() @ xf


def recursive_construct_host(x: np.ndarray, seed_term: int, depth: int,
                             topk: int, dedup: bool = True
                             ) -> List[Tuple[int, int, int]]:
    """Paper Algorithm 2 on a dense bool incidence matrix (reference only).

    Returns [(src, dst, weight), ...] in DFS discovery order."""
    edges: List[Tuple[int, int, int]] = []
    visited = {int(seed_term)}

    def rec(mask: np.ndarray, term: int, d: int) -> None:
        if d >= depth:
            return
        counts = x[mask].sum(axis=0).astype(np.int64)
        counts[term] = -1
        if dedup:
            for t in visited:
                counts[t] = -1
        order = np.argsort(-counts, kind="stable")[:topk]
        chosen = [int(t) for t in order if counts[t] > 0]
        for t in chosen:
            edges.append((term, t, int(counts[t])))
            if dedup:
                visited.add(t)
        for t in chosen:
            rec(mask & x[:, t].astype(bool), t, d + 1)

    seed_mask = x[:, int(seed_term)].astype(bool)
    rec(seed_mask, int(seed_term), 0)
    return edges


def bfs_construct_host(x: np.ndarray, seed_term: int, depth: int, topk: int,
                       beam: Optional[int] = None, dedup: bool = True
                       ) -> List[Tuple[int, int, int]]:
    """Paper Algorithm 3 on a dense bool incidence matrix (reference).

    Level-synchronous BFS with an optional beam cap (by weight) per level,
    as the device BFS runs it.  Returns [(src, dst, weight), ...]."""
    edges: List[Tuple[int, int, int]] = []
    visited = {int(seed_term)}
    frontier: List[Tuple[np.ndarray, int]] = [
        (x[:, int(seed_term)].astype(bool), int(seed_term))]
    for _ in range(depth):
        # (weight, mask, src, dst)
        candidates: List[Tuple[int, np.ndarray, int, int]] = []
        for mask, term in frontier:
            counts = x[mask].sum(axis=0).astype(np.int64)
            counts[term] = -1
            if dedup:
                for t in visited:
                    counts[t] = -1
            order = np.argsort(-counts, kind="stable")[:topk]
            for t in order:
                t = int(t)
                if counts[t] > 0:
                    edges.append((term, t, int(counts[t])))
                    candidates.append((int(counts[t]),
                                       mask & x[:, t].astype(bool), term, t))
        # level-synchronous: all edge targets recorded this level -> visited
        if dedup:
            visited |= {c[3] for c in candidates}
            seen_lvl = set()
            uniq = []
            for c in sorted(candidates, key=lambda c: -c[0]):
                if c[3] not in seen_lvl:
                    seen_lvl.add(c[3])
                    uniq.append(c)
            candidates = uniq
        else:
            candidates.sort(key=lambda c: -c[0])
        if beam is not None:
            candidates = candidates[:beam]
        frontier = [(c[1], c[3]) for c in candidates]
        if not frontier:
            break
    return edges


class HostIndex(NamedTuple):
    """Host-side inverted + forward index (numpy): ``postings[t]`` is the
    sorted doc-id array of term t; the unique terms of doc d are
    ``fwd_terms[fwd_ptr[d]:fwd_ptr[d+1]]``."""
    postings: List[np.ndarray]
    fwd_terms: np.ndarray
    fwd_ptr: np.ndarray
    vocab_size: int


def build_host_index(doc_terms: Sequence[Sequence[int]], vocab_size: int
                     ) -> HostIndex:
    uniq_per_doc = [np.unique(np.asarray(d, dtype=np.int64)) for d in doc_terms]
    fwd_ptr = np.zeros(len(doc_terms) + 1, np.int64)
    np.cumsum([len(u) for u in uniq_per_doc], out=fwd_ptr[1:])
    fwd_terms = (np.concatenate(uniq_per_doc) if uniq_per_doc
                 else np.zeros(0, np.int64)).astype(np.int32)
    by_term: List[List[int]] = [[] for _ in range(vocab_size)]
    for d, u in enumerate(uniq_per_doc):
        for t in u:
            by_term[int(t)].append(d)
    postings = [np.asarray(p, dtype=np.int64) for p in by_term]
    return HostIndex(postings, fwd_terms, fwd_ptr, vocab_size)


def _gather_counts(hidx: HostIndex, doc_ids: np.ndarray) -> np.ndarray:
    """Term document-frequencies over a doc subset: one pass over the
    matched docs' forward lists."""
    if doc_ids.size == 0:
        return np.zeros(hidx.vocab_size, np.int64)
    starts = hidx.fwd_ptr[doc_ids]
    ends = hidx.fwd_ptr[doc_ids + 1]
    lens = ends - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(hidx.vocab_size, np.int64)
    shifted = np.concatenate(([0], np.cumsum(lens)[:-1]))
    offs = np.repeat(starts - shifted, lens) + np.arange(total)
    return np.bincount(hidx.fwd_terms[offs], minlength=hidx.vocab_size)


def bfs_construct_host_fast(hidx: HostIndex, seed_terms: Sequence[int], *,
                            depth: int, topk: int, beam: Optional[int] = None,
                            dedup: bool = True) -> List[Tuple[int, int, int]]:
    """Paper Algorithm 3 on the host: postings-list intersection for the
    filter, forward-index aggregation for the frequent-term set.  Returns
    [(src, dst, weight), ...] — the oracle the device BFS must equal."""
    edges: List[Tuple[int, int, int]] = []
    visited = set(int(s) for s in seed_terms)
    frontier = [(hidx.postings[int(s)], int(s)) for s in seed_terms]
    for _ in range(depth):
        candidates: List[Tuple[int, np.ndarray, int, int]] = []
        for doc_ids, term in frontier:
            counts = _gather_counts(hidx, doc_ids)
            counts[term] = -1
            if dedup:
                for t in visited:
                    counts[t] = -1
            # stable sort: ties break by term id, as the device top-k does
            order = np.argsort(-counts, kind="stable")[:topk]
            for t in order:
                t = int(t)
                if counts[t] > 0:
                    edges.append((term, t, int(counts[t])))
                    candidates.append((int(counts[t]),
                                       np.intersect1d(doc_ids, hidx.postings[t],
                                                      assume_unique=True),
                                       term, t))
        if dedup:
            visited |= {c[3] for c in candidates}
            seen_lvl = set()
            uniq = []
            for c in sorted(candidates, key=lambda c: -c[0]):
                if c[3] not in seen_lvl:
                    seen_lvl.add(c[3])
                    uniq.append(c)
            candidates = uniq
        else:
            candidates.sort(key=lambda c: -c[0])
        if beam is not None:
            candidates = candidates[:beam]
        frontier = [(c[1], c[3]) for c in candidates]
        if not frontier:
            break
    return edges


# ---------------------------------------------------------------------------
# Algorithm 3 on the device, batch-major
# ---------------------------------------------------------------------------


class BFSState(NamedTuple):
    masks: torch.Tensor    # (Q*B, W) int32 per-frontier-row filter bitmaps
    terms: torch.Tensor    # (Q*B,) int64 frontier terms (-1 = invalid)
    valid: torch.Tensor    # (Q*B,) bool
    visited: torch.Tensor  # (Q, V) bool


def chunked_top_k(x: torch.Tensor, k: int):
    """Top-k over the last axis in exact ``lax.top_k`` order (values
    descending, lower index first on ties).  Always returns (..., k):
    ``k > V`` clamps to V and pads the missing slots with weight -1 /
    index 0, as the reference's ``chunked_top_k`` does.

    The reference splits the columns into chunks so that under SPMD only
    the per-chunk candidates cross devices; on one GPU one exact pass
    gives the same values and order.  Returns (values, indices int64)."""
    v = x.shape[-1]
    k_eff = min(k, v)
    w, i = topk_lower_index(x, k_eff)
    if k_eff < k:
        w = torch.nn.functional.pad(w, (0, k - k_eff), value=-1)
        i = torch.nn.functional.pad(i, (0, k - k_eff), value=0)
    return w, i


def _check_x_dense(x: torch.Tensor, index: PackedIndex) -> None:
    """The legacy ``x_dense=`` operand must be the port's own layout."""
    if (x.dtype != torch.int8 or x.dim() != 2 or x.shape[0] != index.capacity
            or x.shape[1] < index.vocab_size
            or (x.shape[0] > 1 and x.stride(0) != 1)):
        raise ValueError(
            f"x_dense must be the int8 (capacity, V_pad) incidence with its "
            f"doc axis contiguous, the .t() view of term-major storage that "
            f"QueryContext.x_dense() returns (capacity {index.capacity}, V "
            f"{index.vocab_size}); got {x.dtype} {tuple(x.shape)} with "
            f"strides {x.stride()}")


def _resolve_operands(index, method: str,
                      operands: Optional[Mapping[str, torch.Tensor]], *,
                      x_dense: Optional[torch.Tensor] = None, mesh=None):
    """Unwrap a QueryContext and assemble the method's operands, and the
    shard artifact when a mesh applies (the explicit ``mesh``, else the
    context's).  Returns (index, operands, shards or None).

    Precedence per needed operand: explicit ``operands`` entry > the
    legacy ``x_dense`` argument > the context's cached artifact > a
    one-shot build from a bare index."""
    from repro_torch.core.query import get_count_method
    from repro_torch.core.query_context import QueryContext, pad_transposed
    ops: Dict[str, torch.Tensor] = dict(operands) if operands else {}
    needs = get_count_method(method).needs
    pidx = index.index if isinstance(index, QueryContext) else index
    if x_dense is not None:
        _check_x_dense(x_dense, pidx)
        ops.setdefault("x_dense", x_dense)
    shards = None
    if isinstance(index, QueryContext):
        ctx = index
        mesh = ctx.mesh if mesh is None else mesh
        for name in needs:
            if name not in ops:
                ops[name] = getattr(ctx, name)()
        if mesh is not None:
            shards = ctx.mesh_shards(mesh)
    elif mesh is not None:
        from repro_torch.core.distributed import ShardedIndex
        shards = ShardedIndex(pidx, mesh)
    builders = {"x_dense": lambda: dense_operand(pidx),
                "packed_t": lambda: pidx.packed.T.contiguous(),
                "packed_t_pad": lambda: pad_transposed(pidx.packed)}
    for name in needs:
        if name not in ops:
            ops[name] = builders[name]()
    return pidx, ops, shards


def mask_level(counts: torch.Tensor, terms: torch.Tensor,
               valid: torch.Tensor,
               visited_rows: Optional[torch.Tensor]) -> torch.Tensor:
    """The level masks on (R, V) counts: each row's own term (a term id
    that names no column masks nothing), the visited columns
    (``visited_rows`` (R, V) bool; None without dedup) and the invalid
    rows go to -1."""
    cols = torch.arange(counts.shape[1], device=counts.device)
    counts = torch.where(cols[None, :] == terms.clamp(min=0)[:, None], -1,
                         counts)
    if visited_rows is not None:
        counts = torch.where(visited_rows, -1, counts)
    return torch.where(valid[:, None], counts, -1)


def _expand_level(index: PackedIndex, state: BFSState, n_queries: int,
                  topk: int, dedup: bool, method: str,
                  operands: Mapping[str, torch.Tensor], shards=None):
    """One BFS level for Q queries at once: frontier counts + masks + top-k
    (sharded across a mesh when ``shards`` is given; else the method's
    ``level_fn`` when it has one, else its counts then the masks then
    :func:`chunked_top_k`), then per query the stable dedup and the beam
    re-selection.  Returns the next state and this level's edges as four
    (Q, B, topk) tensors."""
    from repro_torch.core.query import get_count_method
    q = n_queries
    r = state.masks.shape[0]
    b = r // q
    dev = state.masks.device

    m = get_count_method(method)
    if shards is not None:
        from repro_torch.core.distributed import sharded_level_topk
        w_top, idx_top = sharded_level_topk(
            shards, state.masks, state.terms, state.valid, state.visited,
            method, operands, shards.mesh, k=topk, dedup=dedup)
    elif m.level_fn is not None:
        w_top, idx_top = m.level_fn(index, state.masks, state.terms,
                                    state.valid, state.visited, operands,
                                    k=topk, dedup=dedup)
    else:
        counts = mask_level(m.fn(index, state.masks, operands), state.terms,
                            state.valid,
                            state.visited.repeat_interleave(b, dim=0)
                            if dedup else None)
        w_top, idx_top = chunked_top_k(counts, topk)
    w_top = w_top.to(torch.int32)
    idx_top = idx_top.to(torch.int64)
    edge_valid = w_top > 0
    edges = (state.terms[:, None].expand(r, topk),                  # src
             idx_top,                                              # dst
             torch.where(edge_valid, w_top, 0),                    # weight
             edge_valid)
    edges = tuple(e.reshape(q, b, topk) for e in edges)

    # candidate pool of the next frontier, per query: B*k (dst, weight, row)
    flat_w = torch.where(edge_valid, w_top, -1).reshape(q, b * topk)
    flat_dst = idx_top.reshape(q, b * topk)
    flat_parent = torch.arange(b, device=dev).repeat_interleave(topk)
    if dedup:
        # one candidate per dst term, the heaviest: stable sort by -weight,
        # then stably by dst; the first of each dst run is the heaviest
        order = torch.sort(-flat_w, dim=1, stable=True).indices
        dst_sorted = torch.gather(flat_dst, 1, order)
        o2 = torch.sort(dst_sorted, dim=1, stable=True).indices
        ds2 = torch.gather(dst_sorted, 1, o2)
        first2 = torch.ones_like(ds2, dtype=torch.bool)
        first2[:, 1:] = ds2[:, 1:] != ds2[:, :-1]
        keep_sorted = torch.zeros_like(first2).scatter(1, o2, first2)
        keep = torch.zeros_like(first2).scatter(1, order, keep_sorted)
        flat_w = torch.where(keep, flat_w, -1)

    w_next, cand = topk_lower_index(flat_w, b)                     # (Q, B)
    next_valid = (w_next > 0).reshape(r)
    next_dst = torch.gather(flat_dst, 1, cand).reshape(r)
    parent_row = (flat_parent[cand]
                  + b * torch.arange(q, device=dev)[:, None]).reshape(r)
    post = index.packed.index_select(1, next_dst.clamp(min=0)).T  # (R, W)
    next_masks = torch.where(next_valid[:, None],
                             state.masks[parent_row] & post, 0)
    visited = state.visited
    if dedup:
        # every edge target recorded this level becomes visited
        vis = visited.to(torch.int32).scatter_add(
            1, idx_top.clamp(min=0).reshape(q, b * topk),
            edge_valid.reshape(q, b * topk).to(torch.int32))
        visited = vis > 0
    new_state = BFSState(next_masks.contiguous(),
                         torch.where(next_valid, next_dst, -1), next_valid,
                         visited)
    return new_state, edges


def initial_state(index: PackedIndex, seed_terms, *, beam: int,
                  scope_mask: Optional[torch.Tensor] = None) -> BFSState:
    """The depth-0 frontier of Q queries: seed_terms (Q, S) padded with -1
    (S <= beam).  Row ``q * beam + j`` holds seed j of query q, its filter
    the seed's postings ANDed with ``scope_mask``; every seed is visited."""
    dev = index.packed.device
    seeds = torch.as_tensor(seed_terms, device=dev).to(torch.int64)
    q, s = seeds.shape
    b = beam
    if s > b:
        raise ValueError(f"{s} seed slots exceed beam={b}")
    v, w = index.vocab_size, index.n_words
    seed_valid = seeds >= 0
    sc = seeds.clamp(min=0)
    post = index.packed.index_select(1, sc.reshape(-1)).T.reshape(q, s, w)
    masks0 = torch.zeros((q, b, w), dtype=torch.int32, device=dev)
    masks0[:, :s] = torch.where(seed_valid[..., None], post, 0)
    if scope_mask is not None:
        masks0 &= scope_mask.to(dev)
    terms0 = torch.full((q, b), -1, dtype=torch.int64, device=dev)
    terms0[:, :s] = torch.where(seed_valid, sc, -1)
    valid0 = torch.zeros((q, b), dtype=torch.bool, device=dev)
    valid0[:, :s] = seed_valid
    visited0 = torch.zeros((q, v), dtype=torch.int32, device=dev).scatter_add(
        1, sc, seed_valid.to(torch.int32)) > 0
    return BFSState(masks0.reshape(q * b, w), terms0.reshape(-1),
                    valid0.reshape(-1), visited0)


def bfs_construct_batch(index, seed_terms, *, depth: int, topk: int,
                        beam: int, dedup: bool = True, method: str = "gemm",
                        x_dense: Optional[torch.Tensor] = None,
                        operands: Optional[Mapping[str, torch.Tensor]] = None,
                        scope_mask: Optional[torch.Tensor] = None,
                        mesh=None) -> CoocNetwork:
    """Paper Algorithm 3 for a batch of queries: seed_terms (Q, S) term
    ids padded with -1 (S <= beam).

    ``index`` is a PackedIndex or a QueryContext (whose cached per-epoch
    artifacts feed the method).  Each level evaluates every frontier row
    of every query against the whole index in one pass, then a per-query
    top-k.  ``scope_mask`` (W,) restricts all queries to a document subset
    (ANDed into the depth-0 filters; every deeper filter inherits it).
    Returns a CoocNetwork of ``Q * depth * beam * topk`` slots, ordered
    query, level, frontier row, rank — the reference's vmapped layout.
    No step reads a device value back to the host.

    ``x_dense`` is a legacy spelling of ``operands={"x_dense": ...}``: the
    port's int8 operand, ``QueryContext.x_dense()``.  ``mesh`` (default:
    the context's) runs each level term- or doc-sharded across the mesh
    (:mod:`repro_torch.core.distributed`), bit-identical to one device.
    """
    index, ops, shards = _resolve_operands(index, method, operands,
                                           x_dense=x_dense, mesh=mesh)
    state = initial_state(index, seed_terms, beam=beam, scope_mask=scope_mask)
    q = state.visited.shape[0]
    levels = []
    for _ in range(depth):
        state, edges = _expand_level(index, state, q, topk, dedup, method,
                                     ops, shards)
        levels.append(edges)
    src, dst, wt, ev = (torch.stack([e[i] for e in levels], dim=1).reshape(-1)
                        for i in range(4))
    return CoocNetwork(src=src.to(torch.int32), dst=dst.to(torch.int32),
                       weight=wt.to(torch.int32), valid=ev)


def bfs_construct(index, seed_terms, *, depth: int, topk: int, beam: int,
                  dedup: bool = True, method: str = "gemm",
                  x_dense: Optional[torch.Tensor] = None,
                  operands: Optional[Mapping[str, torch.Tensor]] = None,
                  scope_mask: Optional[torch.Tensor] = None,
                  mesh=None) -> CoocNetwork:
    """One query: seed_terms (S,) padded with -1 — the Q = 1 case of
    :func:`bfs_construct_batch`; ``depth * beam * topk`` edge slots."""
    seeds = torch.as_tensor(seed_terms).reshape(1, -1)
    return bfs_construct_batch(index, seeds, depth=depth, topk=topk,
                               beam=beam, dedup=dedup, method=method,
                               x_dense=x_dense, operands=operands,
                               scope_mask=scope_mask, mesh=mesh)


def construct(index, spec) -> "QueryResult":
    """Run one QuerySpec and return a QueryResult — the reference
    semantics a micro-batched engine result must equal.  A scoped spec
    needs a QueryContext to resolve the scope name."""
    from repro_torch.core.query import QueryResult
    from repro_torch.core.query_context import QueryContext
    scope_mask = None
    if spec.scope is not None:
        if not isinstance(index, QueryContext):
            raise ValueError(
                f"spec.scope={spec.scope!r} needs a QueryContext to resolve "
                "the scope name to a document bitmap; got a bare index")
        scope_mask = index.scope(spec.scope)
    net = bfs_construct(index, torch.from_numpy(spec.seed_row()),
                        depth=spec.depth, topk=spec.topk, beam=spec.beam,
                        dedup=spec.dedup, method=spec.method,
                        scope_mask=scope_mask)
    epoch = index.epoch if isinstance(index, QueryContext) else 0
    return QueryResult(network=net, spec=spec, epoch=epoch)
