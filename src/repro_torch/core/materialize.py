"""Whole-corpus network materialization (the paper's whole-corpus artifact).

Mirrors ``repro.core.materialize`` in its exact mode.  The BFS query path
serves seed-rooted neighborhoods; the whole network is every term's
top-``k`` heaviest co-occurrence neighbors.  The (V, V) count matrix is
never allocated: rows are swept in blocks of ``row_tile`` terms, a
block's filter bitmaps are its postings rows (AND a scope bitmap, if any),
so ``C[i, j] = popcount(post_i & scope & post_j)`` over exactly the scoped
documents, and each block's (row_tile, V) counts reduce to (row_tile, k)
before the next block starts.

Counts come from ``method=``:

* ``"pallas"`` — the hand-written int8 tensor-core co-occurrence kernel
  (``kernels.ops.cooccur_counts``): one launch per :data:`GROUP`
  consecutive row blocks.  On one device each group counts over its own
  documents only: those holding one of its terms (and in the scope), a
  few percent of a Zipf corpus for all but the head groups.  Its two
  0/1 operands over those documents, (rows, K) and (V, K), are staged
  from the context's forward index (doc -> terms, an epoch artifact)
  with a plan of every group's documents made in one pass over the
  (doc, term) pairs, whose sizes reach the host once a sweep; the dense
  incidence is not built.  Where this epoch's ``x_dense`` already exists,
  a group whose staged operands would outgrow one group's mask unpack
  reads ``x_dense`` over every document instead, so no second buffer of
  its size is allocated.  Under a mesh every group reads ``x_dense``.
  The reference streams column tiles through a running top-k merge
  instead; one exact top-k over each row's counts gives the same values
  and tie order (the reference's own docstring says the two orders
  agree);
* ``"gemm"``, ``"popcount"``, ``"fused"`` and any registered method — the
  count-method registry, one call per row block.

Either way the top-k is exact ``lax.top_k`` order (ties to the lower term
id), self-pairs are excluded and zero counts emit no edge.  With a
:class:`QueryContext` the dense incidence and the transposed postings are
the context's epoch artifacts, and the finished network is cached per
(k, method, scope, row tile), invalidated by an ingest or a scope
redefinition.

``scope="all-time"`` answers over the live and the cold tier together:
the same sweep over :meth:`QueryContext.all_time_index`, the cold blocks'
word rows stacked under the live bitmap, cached per (epoch,
``cold_version()``).  With nothing spilled it is the live network.

**Approximate mode** (``mode="approx"``, :mod:`repro_torch.core.sketch`):
per-term MinHash signatures feed LSH banding on the host, and each row
block is counted exactly against its candidate columns only, gathered
into a (W, C) sub-index (pad columns zeroed) that the count-method
registry takes unchanged — under ``"pallas"`` that is the postings kernel
(``kernels.ops.postings_counts``) on the gathered operands.  Emitted edge
weights are exact; edges can only be missed.

**Mesh** (``mesh=``, default the context's;
:mod:`repro_torch.core.distributed`): ``shard_strategy="rows"`` (the
default under ``"auto"``) gives each shard a contiguous range of the row
blocks against the whole index; ``"cols"`` splits each row block's
columns across the shards and merges only their top-k candidates.  Both
give the single-device network bit for bit.  The approximate sweep under
a mesh counts each candidate tile through the column-split merge.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.cooccurrence import _resolve_operands, chunked_top_k
from repro_torch.core.inverted_index import (
    ForwardIndex,
    PackedIndex,
    dense_operand,
    forward_index,
    from_uint32,
    to_uint32,
    unpack_bitmap,
)
from repro_torch.core.network import CoocNetwork
from repro_torch.core.query import get_count_method
from repro_torch.core.query_context import QueryContext
from repro_torch.core.sketch import (
    DEFAULT_NUM_PERM,
    DEFAULT_THRESHOLD,
    TILE_QUANTUM,
    ApproxCoocNetwork,
    ApproxStats,
    candidate_columns,
    estimate_recall,
    gathered_top_k,
    hash_coefficients,
    lsh_params,
    minhash_signatures,
    pad_candidates,
)
from repro_torch.kernels import ops


#: row blocks of method "pallas" per co-occurrence launch: one pass over
#: the group's documents serves GROUP * row_tile terms.  Chosen by
#: measurement among 1, 2, 4 and 8 on an H100, each launch then reading
#: all of ``x_dense`` (chip_smoke.py, phase kernels; PERF.md)
GROUP = 4


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _row_masks(rows: torch.Tensor, r0: int, bm: int) -> torch.Tensor:
    """The (bm, W) filter bitmaps of terms ``[r0, r0 + bm)``: their rows of
    the (V, W) transposed postings, all-zero past V."""
    masks = rows.new_zeros((bm, rows.shape[1]))
    blk = rows[r0:r0 + bm]
    masks[:blk.shape[0]] = blk
    return masks


def _row_top_k(counts: torch.Tensor, r0: int, bm: int, k: int):
    """The (bm, k) top-k of a block's (bm, V) counts, self pairs
    excluded (the ``cooc.materialize.topk`` span)."""
    v = counts.shape[1]
    with tracing.span("cooc.materialize.topk"):
        # self pairs; a pad row's entry is sliced off with its row
        dev = counts.device
        terms = torch.arange(r0, r0 + bm, device=dev).clamp(max=v - 1)
        counts = counts.index_put(
            (torch.arange(bm, device=dev), terms),
            torch.tensor(-1, dtype=counts.dtype, device=dev))
        return chunked_top_k(counts, k)


def _block_topk(pidx: PackedIndex, rows: torch.Tensor,
                scope_mask: Optional[torch.Tensor], operands, r0: int, *,
                k: int, bm: int, method: str, shards=None):
    """Top-k neighbors of terms ``[r0, r0 + bm)``: (weights, ids), both
    (bm, k), weight -1 marking empty slots.  ``rows`` is the (V, W)
    transposed postings; rows past V have all-zero masks.  ``bm`` is a
    multiple of the row tile: one row block, or a group of them.  With
    ``shards`` the block's columns split across the mesh
    (:func:`~repro_torch.core.distributed.sharded_block_topk`).  While a
    profile records, the block's three phases are spans of
    :mod:`repro_torch.tracing`: ``cooc.materialize.masks`` (the filter
    bitmaps and their unpack; attribute ``docs``, the documents the count
    runs over: all of them here), ``.count`` and ``.topk``."""
    v = pidx.vocab_size
    with tracing.span("cooc.materialize.masks", r0=r0, docs=pidx.n_docs):
        masks = _row_masks(rows, r0, bm)
        if scope_mask is not None:
            masks &= scope_mask[None, :]
        if shards is None and method == "pallas":
            x_l = unpack_bitmap(masks, torch.int8).t()          # (D, bm)
    if shards is not None:
        from repro_torch.core.distributed import sharded_block_topk
        own = torch.arange(r0, r0 + bm, device=masks.device)
        return sharded_block_topk(shards, masks, own, operands, k=k,
                                  method=method, mesh=shards.mesh)
    with tracing.span("cooc.materialize.count"):
        if method == "pallas":
            counts = ops.cooccur_counts(x_l, operands["x_dense"])[:, :v]
        else:
            counts = get_count_method(method).fn(pidx, masks, operands)
    return _row_top_k(counts, r0, bm, k)


class _SweepPlan(NamedTuple):
    """Where each row group's compacted operands come from.  Group ``g``
    (terms ``[g * step, (g + 1) * step)``) counts over ``n_union[g]``
    documents: those holding any of its terms (and in the scope), in
    ascending order, K_pad = ``n_union[g]`` rounded up to 16 of them.
    ``a_flat[poff[g]:][:n_pairs[g]]`` are the flat positions of the ones
    of its (rows, K_pad) operand, one a (doc, term) pair of its terms;
    ``b_flat[boff[g]:][:n_terms[g]]`` those of its (V, K_pad) operand,
    one a (doc, term) pair of its documents.  The sizes are host arrays,
    read from the device once."""

    a_flat: torch.Tensor      # int64
    b_flat: torch.Tensor      # int64
    n_union: np.ndarray       # (G,) int64
    n_pairs: np.ndarray
    n_terms: np.ndarray
    poff: np.ndarray
    boff: np.ndarray


def _k_pad(n):
    """A compacted operand's doc axis: 16-byte rows, as TMA needs."""
    return (n + 15) // 16 * 16


def _sweep_plan(fwd: ForwardIndex, scope_mask: Optional[torch.Tensor], *,
                step: int, n_groups: int) -> _SweepPlan:
    """Every row group's documents and operand positions, from the
    forward index: one sort of the (doc, term) pairs by (group, doc),
    segment sums for the sizes, whose copy to the host is the only
    synchronise, then each group's documents' terms expanded.  Pairs
    outside the scope go to a group past the last, never read."""
    cap = fwd.ptr.shape[0] - 1
    dev = fwd.terms.device
    lens = fwd.ptr.diff()
    doc = torch.repeat_interleave(torch.arange(cap, device=dev), lens,
                                  output_size=fwd.nnz)
    term = fwd.terms.to(torch.int64)
    grp = term // step
    if scope_mask is not None:
        inside = (scope_mask[doc >> 5] >> (doc & 31).to(torch.int32)) & 1
        grp = torch.where(inside.bool(), grp, n_groups)
    key, order = torch.sort(grp * cap + doc)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    gid = key // cap
    uid = torch.cumsum(first, 0) - 1          # among all (group, doc)
    n_union = torch.zeros(n_groups + 1, dtype=torch.int64, device=dev)
    n_union.index_add_(0, gid, first.to(torch.int64))
    uoff = torch.cumsum(n_union, 0) - n_union
    kp = _k_pad(n_union)
    a_flat = (term[order] - gid * step) * kp[gid] + uid - uoff[gid]
    n_pairs = torch.zeros_like(n_union).index_add_(0, gid,
                                                   torch.ones_like(gid))
    # each (group, doc) once, in uid order: its doc and group
    udoc = torch.zeros_like(key).index_put_((uid,), key - gid * cap)
    ugid = torch.zeros_like(key).index_put_((uid,), gid)
    n_terms = torch.zeros_like(n_union).index_add_(
        0, gid, torch.where(first, lens[key - gid * cap], 0))
    sizes = torch.stack([n_union, n_pairs, n_terms])[:, :n_groups].cpu()
    n_union_h, n_pairs_h, n_terms_h = sizes.numpy()
    n_u, n_b = int(n_union_h.sum()), int(n_terms_h.sum())
    udoc, ugid = udoc[:n_u], ugid[:n_u]
    ulen = lens[udoc]
    # the (V, K_pad) ones: term t of the i-th document of group g
    rep = torch.repeat_interleave(torch.stack([
        fwd.ptr[udoc] - (torch.cumsum(ulen, 0) - ulen),
        kp[ugid],
        torch.arange(n_u, device=dev) - uoff[ugid]]), ulen, dim=1,
        output_size=n_b)
    entry = rep[0] + torch.arange(n_b, device=dev)
    b_flat = fwd.terms[entry].to(torch.int64) * rep[1] + rep[2]
    return _SweepPlan(a_flat, b_flat, n_union_h, n_pairs_h, n_terms_h,
                      np.cumsum(n_pairs_h) - n_pairs_h,
                      np.cumsum(n_terms_h) - n_terms_h)


def _unpack_bytes(bm: int, n_slots: int) -> int:
    """Device bytes a row group of ``bm`` terms holds to read ``x_dense``:
    its (n_slots, bm) int8 masks and one int32 bit intermediate of their
    unpack (about 1 GB at the CSL scale)."""
    return 5 * bm * n_slots


def _staged_block_topk(plan: _SweepPlan, g: int, abuf: torch.Tensor,
                       bbuf: torch.Tensor, r0: int, *, k: int, bm: int,
                       v: int):
    """:func:`_block_topk` of row group ``g`` over its own documents only.
    Its operands are staged into the all-zero ``abuf`` and ``bbuf`` from
    the plan: (bm, K_pad) int8, entry (r, i) = 1 iff the group's i-th
    document holds term ``r0 + r``, and (V, K_pad) int8, entry (t, i) = 1
    iff it holds ``t``; the kernel counts over K_pad, and the ones are
    cleared after it.  A group with no documents launches nothing and
    emits no edge."""
    n = int(plan.n_union[g])
    kp = _k_pad(n)
    dev = abuf.device
    with tracing.span("cooc.materialize.masks", r0=r0, docs=n):
        if n == 0:
            return (torch.full((bm, k), -1, dtype=torch.int32, device=dev),
                    torch.zeros((bm, k), dtype=torch.int64, device=dev))
        fa = plan.a_flat[plan.poff[g]:][:plan.n_pairs[g]]
        fb = plan.b_flat[plan.boff[g]:][:plan.n_terms[g]]
        abuf.index_fill_(0, fa, 1)
        bbuf.index_fill_(0, fb, 1)
    with tracing.span("cooc.materialize.count"):
        counts = ops.cooccur_counts(abuf[:bm * kp].view(bm, kp).t(),
                                    bbuf[:v * kp].view(v, kp).t())
        abuf.index_fill_(0, fa, 0)
        bbuf.index_fill_(0, fb, 0)
    return _row_top_k(counts, r0, bm, k)


def _compacted_sweep(pidx: PackedIndex, ctx: Optional[QueryContext],
                     mask_rows, scope_mask: Optional[torch.Tensor], *,
                     k: int, bm: int):
    """The single-device exact ``"pallas"`` sweep: one kernel launch a
    group of :data:`GROUP` row blocks, each over the group's own
    documents (:func:`_staged_block_topk`).  The forward index, and the
    unscoped plan, are the context's epoch artifacts.  Where this epoch's
    ``x_dense`` already exists, a group whose staged operands would hold
    more than its unpack does reads ``x_dense`` over every document
    (:func:`_block_topk`), so the staging buffers stay that small; else
    every group is staged, in buffers sized by the largest union and
    freed at the end.  ``mask_rows()`` gives the (V, W) mask rows of such
    a group.  Returns the (n_rows, k) weights and ids."""
    v = pidx.vocab_size
    n_rows = _round_up(v, bm)
    step = GROUP * bm
    n_groups = -(-n_rows // step)
    plan_key = ("materialize", "plan", step)
    plan = (ctx.cached_artifact(plan_key, version=0)
            if ctx is not None and scope_mask is None else None)
    if plan is None:
        fwd = ctx.forward_index() if ctx is not None else forward_index(pidx)
        plan = _sweep_plan(fwd, scope_mask, step=step, n_groups=n_groups)
        if ctx is not None and scope_mask is None:
            ctx.store_artifact(plan_key, plan, version=0)
    x_dense = ctx.built_artifact("x_dense") if ctx is not None else None
    kp = _k_pad(plan.n_union)
    staged = np.ones(n_groups, dtype=bool)
    if x_dense is not None:
        staged = (v + step) * kp <= _unpack_bytes(step, pidx.capacity)
    k_max = int(kp[staged].max()) if staged.any() else 0
    abuf = torch.zeros((step * k_max,), dtype=torch.int8, device=pidx.device)
    bbuf = torch.zeros((v * k_max,), dtype=torch.int8, device=pidx.device)
    rows = None if staged.all() else mask_rows()
    ws, ids = [], []
    for g, r0 in enumerate(range(0, n_rows, step)):
        bm_g = min(step, n_rows - r0)
        if staged[g]:
            w_b, i_b = _staged_block_topk(plan, g, abuf, bbuf, r0, k=k,
                                          bm=bm_g, v=v)
        else:
            w_b, i_b = _block_topk(pidx, rows, scope_mask,
                                   {"x_dense": x_dense}, r0, k=k, bm=bm_g,
                                   method="pallas")
        ws.append(w_b)
        ids.append(i_b)
    return torch.cat(ws), torch.cat(ids)


def _edge_slots(run_w: torch.Tensor, run_i: torch.Tensor):
    """(src, dst, weight, valid) edge slots of (V, k) top-k weights and
    ids: slot ``i*k + j`` is term ``i``'s j-th neighbor; zero and negative
    weights are invalid (dst -1, weight 0)."""
    v, k = run_w.shape
    valid = run_w > 0
    return (torch.arange(v, dtype=torch.int32,
                         device=run_w.device).repeat_interleave(k),
            torch.where(valid, run_i, -1).reshape(-1),
            torch.where(valid, run_w, 0).reshape(-1),
            valid.reshape(-1))


def _approx_block_topk(pidx: PackedIndex, rows: torch.Tensor, operands,
                       r0: int, cand: np.ndarray, rows_pos: np.ndarray, *,
                       k: int, bm: int, method: str, mesh=None):
    """Top-k neighbors of terms ``[r0, r0 + bm)`` over their LSH candidate
    columns only: (weights, global ids), both (bm, k) int32.

    ``cand`` (C,) holds the sorted global candidate ids, -1 padded;
    ``rows_pos`` (bm,) each row's own column in it (C when absent).  The
    candidates gather into a (W, C) sub-index whose pad columns are zero,
    so a pad column counts 0 and never emits an edge; under ``"gemm"``
    the dense operand's term-major rows are gathered, so the doc axis
    stays contiguous.  The count-method registry runs on the sub-problem
    unchanged; under a ``mesh`` the sub-problem's columns split across it
    (:func:`~repro_torch.core.distributed.sharded_block_topk`, each shard
    counting through the registry, so "pallas" is the postings kernel as
    on one device)."""
    dev = pidx.device
    masks = _row_masks(rows, r0, bm)
    cand_t = torch.from_numpy(cand).to(dev)
    pad = cand_t < 0
    safe = cand_t.clamp(min=0).to(torch.int64)
    sub_packed = pidx.packed.index_select(1, safe)
    sub_packed[:, pad] = 0
    sub_df = torch.where(pad, 0, pidx.doc_freq.index_select(0, safe))
    sub_index = PackedIndex(sub_packed, sub_df, pidx.n_docs)
    sub_ops = {}
    if "x_dense" in operands:
        x_t = operands["x_dense"].t().index_select(0, safe)     # (C, D)
        x_t[pad] = 0
        sub_ops["x_dense"] = x_t.t()
    if mesh is not None:
        from repro_torch.core.distributed import sharded_block_topk
        w, loc = sharded_block_topk(
            sub_index, masks, torch.from_numpy(rows_pos).to(dev), sub_ops,
            k=k, method=method, mesh=mesh, cooc_gemm=False)
        ids = cand_t.clamp(min=0).to(torch.int32)[loc]
        ids[:, min(k, len(cand)):] = 0
        return w, ids
    counts = get_count_method(method).fn(sub_index, masks, sub_ops)
    cols = torch.arange(len(cand), device=dev)
    counts = torch.where(
        cols[None, :] == torch.from_numpy(rows_pos).to(dev)[:, None], -1,
        counts)
    return gathered_top_k(counts, cand_t, k)


def _approx_sweep(pidx: PackedIndex, rows: torch.Tensor, operands,
                  per_block: List[Optional[np.ndarray]], *, k: int, bm: int,
                  method: str, mesh=None):
    """The row-block loop of ``mode="approx"``: each block with
    candidates is counted against them (:func:`_approx_block_topk`), a
    block without any is skipped with no device work.  Returns the (V, k)
    weights and ids and the tile units counted."""
    v, dev = pidx.vocab_size, pidx.device
    tiles_counted = 0
    ws, ids = [], []
    for bi, cols in enumerate(per_block):
        if cols is None:
            ws.append(torch.full((bm, k), -1, dtype=torch.int32, device=dev))
            ids.append(torch.zeros((bm, k), dtype=torch.int32, device=dev))
            continue
        cand = pad_candidates(cols, v)                    # (C,) -1-padded
        tiles_counted += len(cand) // TILE_QUANTUM
        r0 = bi * bm
        terms = np.arange(r0, r0 + bm, dtype=np.int64)
        pos = np.minimum(np.searchsorted(cols, np.clip(terms, 0, v - 1)),
                         len(cols) - 1)
        present = (cols[pos] == terms) & (terms < v)
        rows_pos = np.where(present, pos, len(cand)).astype(np.int64)
        w_b, i_b = _approx_block_topk(pidx, rows, operands, r0, cand,
                                      rows_pos, k=k, bm=bm, method=method,
                                      mesh=mesh)
        ws.append(w_b)
        ids.append(i_b)
    return torch.cat(ws)[:v], torch.cat(ids)[:v], tiles_counted


def _materialize_approx(index, ctx, *, k: int, method: str, row_tile: int,
                        mesh, threshold: float, num_perm: int,
                        sketch_seed: int,
                        use_cache: bool) -> ApproxCoocNetwork:
    """The ``mode="approx"`` sweep: signatures -> banding -> candidate
    tiles -> exact counts on the candidates only, with the work counted
    in (row_tile, TILE_QUANTUM) tile units against the exact sweep's."""
    pidx = ctx.index if ctx is not None else index
    v, w = pidx.vocab_size, pidx.n_words
    bm = min(row_tile, _round_up(v, 8))

    cache_key = None
    if ctx is not None and use_cache:
        cache_key = ("materialize", "approx", k, method, bm,
                     _mesh_key(mesh), float(threshold), int(num_perm),
                     int(sketch_seed))
        hit = ctx.cached_artifact(cache_key, version=0)
        if hit is not None:
            return hit

    bands, rows_per_band = lsh_params(threshold, num_perm)
    if ctx is not None:
        sigs_dev = ctx.term_signatures(num_perm=num_perm, seed=sketch_seed)
    elif mesh is not None:
        from repro_torch.core.distributed import sharded_signatures
        sigs_dev = sharded_signatures(pidx.packed,
                                      *hash_coefficients(num_perm,
                                                         sketch_seed), mesh)
    else:
        sigs_dev = minhash_signatures(pidx.packed,
                                      *hash_coefficients(num_perm,
                                                         sketch_seed))
    sigs = to_uint32(sigs_dev)
    active = pidx.doc_freq.cpu().numpy() > 0
    per_block, n_pairs = candidate_columns(sigs, b=bands, r=rows_per_band,
                                           active=active, row_tile=bm)

    # candidate tiles re-gather columns per block: "gemm" gathers rows of
    # the dense operand, every other method reads the gathered postings
    operands = {}
    if "x_dense" in get_count_method(method).needs:
        operands["x_dense"] = (ctx.x_dense() if ctx is not None
                               else dense_operand(pidx))
    rows = (ctx.packed_t_pad()[:v, :w] if ctx is not None
            else pidx.packed.T)
    run_w, run_i, tiles_counted = _approx_sweep(
        pidx, rows, operands, per_block, k=k, bm=bm, method=method,
        mesh=mesh)
    src, dst, weight, valid = _edge_slots(run_w, run_i)

    n_stripes = _round_up(v, TILE_QUANTUM) // TILE_QUANTUM
    n_blocks = _round_up(v, bm) // bm
    recall = estimate_recall(sigs, src.cpu().numpy(), dst.cpu().numpy(),
                             valid.cpu().numpy(), b=bands, r=rows_per_band)
    net = ApproxCoocNetwork(
        src, dst, weight, valid,
        recall_estimate=recall,
        stats=ApproxStats(tiles_counted=int(tiles_counted),
                          tiles_total=int(n_blocks * n_stripes),
                          candidate_pairs=int(n_pairs),
                          num_perm=int(num_perm),
                          threshold=float(threshold),
                          bands=int(bands),
                          rows_per_band=int(rows_per_band)),
    )
    if cache_key is not None:
        ctx.store_artifact(cache_key, net)
    return net


def _mesh_key(mesh):
    """A mesh's part of a cache key: its shape and every device position,
    so two shards on one card are not four (None off a mesh)."""
    return None if mesh is None else mesh.key


def materialize(index, *, k: int = 8, method: str = "gemm",
                scope: Optional[str] = None, scope_mask=None,
                row_tile: int = 128, col_tile: int = 512,
                use_cache: bool = True, mesh=None,
                shard_strategy: str = "auto", mode: str = "exact",
                threshold: float = DEFAULT_THRESHOLD,
                num_perm: int = DEFAULT_NUM_PERM,
                sketch_seed: int = 0) -> CoocNetwork:
    """Materialize the corpus co-occurrence network, top-``k`` per term.

    index: a PackedIndex, or a QueryContext (cached artifacts + result
    caching).  method: ``"pallas"`` runs the co-occurrence kernel; any
    registered count method runs through the registry.  scope: a context
    scope NAME (time bucket, source tag), or ``"all-time"`` for the live
    and cold tiers together; scope_mask: an explicit (W,) doc
    bitmap, uint32 numpy or an int32 bit-pattern tensor (mutually
    exclusive with ``scope``).  Either way the result is exactly the
    network of an index holding only the scoped documents.

    Returns a :class:`CoocNetwork` with ``V * k`` edge slots — slot
    ``i*k + j`` is term ``i``'s j-th heaviest neighbor (``src=i``), ties
    broken toward the lower term id, self-pairs and zero counts invalid
    (dst -1, weight 0).  Beyond the cached incidence and this O(V·k)
    result, the peak transient is one row block's (row_tile, V) counts;
    with ``method="pallas"`` it is one group's GROUP x (row_tile, V) int32
    counts (134 MB at the CSL scale, GROUP = 4 and row_tile = 128) and the
    sweep's staging buffers, (GROUP * row_tile + V) int8 bytes a document
    of the largest group's union: about the size of ``x_dense`` where the
    head group holds nearly every document, and never more than one
    group's (GROUP * row_tile, D) int8 masks and an int32 bit intermediate
    of their unpack (203 MB and 811 MB) where ``x_dense`` is already built.

    mode="approx" (``threshold=``, ``num_perm=``, ``sketch_seed=``):
    sketch-pruned materialization (:mod:`repro_torch.core.sketch`).  Per-term
    MinHash signatures (``num_perm`` permutations) feed LSH banding at the
    Jaccard ``threshold``; each row block is counted exactly against only
    its candidate columns, and blocks with none are skipped.  Returns an
    :class:`~repro_torch.core.sketch.ApproxCoocNetwork`: the same edge
    slots plus ``recall_estimate`` and ``stats``.  Scoped materialization
    stays exact-only (a scope rewrites every filter bitmap, so the live
    signatures would estimate the wrong Jaccard); ``scope="all-time"``
    re-sketches the combined live and cold index.

    ``col_tile`` is the reference's column tile of its streamed "pallas"
    merge.  Here a row block's counts reduce in one exact top-k, so it
    changes no result; it keys the cache as the reference's does, and
    ``"pallas"`` refuses a tile below 1, as the reference's tile
    arithmetic does.

    mesh: a query mesh (:func:`~repro_torch.core.distributed.
    make_cooc_mesh`; default the context's).  ``shard_strategy`` picks
    how it divides the sweep, both bit-exact against one device:
    ``"rows"`` (each shard a contiguous range of row blocks against the
    whole index, held once per distinct device), ``"cols"`` (each row
    block's columns split across the shards, only their top-k candidates
    merged), ``"auto"`` = ``"rows"``.  Off a mesh it is ignored.  Under a
    mesh ``mode="approx"`` counts its candidate tiles column-split.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if method != "pallas":
        get_count_method(method)           # unknown method -> ValueError
    if scope is not None and scope_mask is not None:
        raise ValueError("pass scope= (a context scope name) OR scope_mask= "
                         "(an explicit bitmap), not both")
    ctx = index if isinstance(index, QueryContext) else None
    if scope is not None and ctx is None:
        raise ValueError(
            f"scope={scope!r} needs a QueryContext to resolve the scope "
            "name to a document bitmap; got a bare index")
    if mesh is None and ctx is not None:
        mesh = ctx.mesh
    if mesh is not None:
        from repro_torch.core.distributed import validate_mesh
        validate_mesh(mesh)
    if shard_strategy not in ("auto", "rows", "cols"):
        raise ValueError(f"shard_strategy must be 'auto', 'rows' or 'cols', "
                         f"got {shard_strategy!r}")
    if mode not in ("exact", "approx"):
        raise ValueError(f"mode must be 'exact' or 'approx', got {mode!r}")
    if mode == "approx":
        if scope_mask is not None or (scope is not None
                                      and scope != "all-time"):
            raise ValueError(
                "mode='approx' does not support scoped materialization: "
                "a scope rewrites every filter bitmap, so the live "
                "signatures would estimate the wrong Jaccard — "
                "materialize the scope exactly, or sketch a dedicated "
                "index holding only the scoped documents")
        if shard_strategy == "rows":
            raise ValueError(
                "mode='approx' prunes per row block, so the whole-sweep "
                "shard_strategy='rows' launch does not apply; use "
                "'auto'/'cols' (the sharded candidate merge)")
    if scope == "all-time":
        if ctx.cold_blocks() == 0:
            scope = None                 # nothing spilled: the live network
        else:
            # a live ingest moves the epoch, a new spill the version; a
            # hit builds no stacked index
            key = ("materialize", "all-time", k, method, row_tile, col_tile,
                   _mesh_key(mesh), shard_strategy, mode, float(threshold),
                   int(num_perm), int(sketch_seed))
            ver = ctx.cold_version()
            if use_cache:
                hit = ctx.cached_artifact(key, ver)
                if hit is not None:
                    return hit
            net = materialize(ctx.all_time_index(), k=k, method=method,
                              row_tile=row_tile, col_tile=col_tile,
                              mesh=mesh, shard_strategy=shard_strategy,
                              mode=mode, threshold=threshold,
                              num_perm=num_perm, sketch_seed=sketch_seed)
            if use_cache:
                ctx.store_artifact(key, net, ver)
            return net
    if mode == "approx":
        return _materialize_approx(index, ctx, k=k, method=method,
                                   row_tile=row_tile, mesh=mesh,
                                   threshold=threshold, num_perm=num_perm,
                                   sketch_seed=sketch_seed,
                                   use_cache=use_cache)
    strategy = None if mesh is None else (
        "rows" if shard_strategy == "auto" else shard_strategy)

    pidx = ctx.index if ctx is not None else index
    v, w = pidx.vocab_size, pidx.n_words
    # shrink the tiles toward tiny vocabularies (the column tile only
    # keys the cache: see the docstring)
    bm = min(row_tile, _round_up(v, 8))
    bn = min(col_tile, _round_up(v, 128))
    if method == "pallas" and bn < 1:
        raise ValueError(f"col_tile must be >= 1, got {col_tile}")

    cache_key = None
    cache_ver = 0
    if ctx is not None and use_cache and (scope is not None
                                          or scope_mask is None):
        # versioned by (epoch, scope_version): a redefined scope misses
        # and the new store overwrites the superseded network
        cache_key = ("materialize", k, method, scope, bm, bn,
                     _mesh_key(mesh), strategy)
        cache_ver = ctx.scope_version(scope) if scope is not None else 0
        hit = ctx.cached_artifact(cache_key, cache_ver)
        if hit is not None:
            return hit

    def mask_rows():
        # the context's padded transpose: no second transposed copy of
        # the postings
        return (ctx.packed_t_pad()[:v, :w] if ctx is not None
                else pidx.packed.T)

    compacted = method == "pallas" and mesh is None
    if compacted:
        operands = {}
    elif method == "pallas":
        operands = {"x_dense": ctx.x_dense() if ctx is not None
                    else dense_operand(pidx)}
    else:
        _, operands, _ = _resolve_operands(index, method, None)
    if scope is not None:
        scope_mask = ctx.scope(scope)
    elif scope_mask is not None:
        if not isinstance(scope_mask, torch.Tensor):
            scope_mask = from_uint32(scope_mask, pidx.device)
        scope_mask = scope_mask.to(device=pidx.device, dtype=torch.int32)
        if tuple(scope_mask.shape) != (w,):
            raise ValueError(f"scope_mask shape {tuple(scope_mask.shape)} != "
                             f"({w},) (one uint32 per 32 doc slots)")

    shards = None
    if mesh is not None:
        from repro_torch.core.distributed import shard_index
        shards = shard_index(ctx if ctx is not None else pidx, mesh)
    if compacted:
        run_w, run_i = _compacted_sweep(pidx, ctx, mask_rows, scope_mask,
                                        k=k, bm=bm)
    elif strategy == "rows":
        from repro_torch.core.distributed import sharded_row_block_topk
        run_w, run_i = sharded_row_block_topk(
            shards, mask_rows(), scope_mask, operands, k=k, bm=bm,
            method=method, mesh=mesh)
    else:
        rows = mask_rows()
        ws, ids = [], []
        n_rows = _round_up(v, bm)
        step = GROUP * bm if method == "pallas" else bm
        for r0 in range(0, n_rows, step):
            w_b, i_b = _block_topk(pidx, rows, scope_mask, operands, r0,
                                   k=k, bm=min(step, n_rows - r0),
                                   method=method, shards=shards)
            ws.append(w_b)
            ids.append(i_b)
        run_w, run_i = torch.cat(ws), torch.cat(ids)
    run_w = run_w[:v]                                           # (V, k)
    run_i = run_i[:v].to(torch.int32)
    net = CoocNetwork(*_edge_slots(run_w, run_i))
    if cache_key is not None:
        ctx.store_artifact(cache_key, net, cache_ver)
    return net
