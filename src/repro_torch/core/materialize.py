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
  few percent of a Zipf corpus for all but the head groups.  Those
  documents are counted in chunks of at most :data:`DOC_CHUNK`, one
  launch a chunk, and the chunks' int32 counts added.  A chunk's two 0/1
  operands, (rows, K) and (V, K), are staged from the context's forward
  index (doc -> terms, an epoch artifact) with a plan of every group's
  chunks made in one pass over the (doc, term) pairs, whose sizes reach
  the host once a sweep; the dense incidence is not built
  (:func:`_compacted_sweep`).  Under a mesh every group reads all of
  ``x_dense`` (:func:`_block_topk`, from
  ``distributed.sharded_row_block_topk`` or ``sharded_block_topk``).
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
from repro_torch.core.cooccurrence import _resolve_operands
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
from repro_torch.kernels import ops, ref


#: row blocks of method "pallas" per row group: one pass over the group's
#: documents serves GROUP * row_tile terms.  Chosen by measurement among
#: 1, 2, 4 and 8 on an H100 when each launch read all of ``x_dense``
#: (chip_smoke.py, phase kernels; PERF.md); not measured again since a
#: group counts over its own documents only
GROUP = 4

#: documents of a row group's union counted per co-occurrence launch of
#: the staged "pallas" sweep.  A larger union is counted in chunks of this
#: many documents, whose int32 counts are added, so the staging buffers
#: hold (GROUP * row_tile + V) int8 bytes a document of one chunk, not of
#: the largest union: 8.7 GB at 65,536 terms, 4.3 GB at 30,454.  A
#: multiple of 16 (TMA's 16-byte rows).  Chosen by measurement among
#: 2^17, 2^18 and 2^19 on an H100 (PERF.md): a network of 396,209
#: documents over 65,536 terms took 0.31-0.32 s at each; one of 7,750,000
#: over 30,454 took 0.705-0.712 s at 2^17 against 0.691-0.702 s at 2^18
#: and 0.695-0.701 s at 2^19 (the extra launches' count writes and
#: adds), for half and a quarter of the staging memory of the others
DOC_CHUNK = 1 << 17


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _row_masks(rows: torch.Tensor, r0: int, bm: int) -> torch.Tensor:
    """The (bm, W) filter bitmaps of terms ``[r0, r0 + bm)``: their rows of
    the (V, W) transposed postings, all-zero past V."""
    masks = rows.new_zeros((bm, rows.shape[1]))
    blk = rows[r0:r0 + bm]
    masks[:blk.shape[0]] = blk
    return masks


def _row_top_k(counts: torch.Tensor, r0: int, k: int):
    """The top-k of a block's (bm, V) counts, self pairs excluded (the
    ``cooc.materialize.topk`` span): ``ops.row_top_k``, the hand-written
    kernel on a CUDA tensor, for k up to its limit; above it the plain
    version, ``torch.topk`` over int64 keys.  Either way no device tensor
    is built from a host value, so the sweep never waits for the device
    here."""
    with tracing.span("cooc.materialize.topk"):
        if k > ops.ROW_TOPK_MAX_K:
            return ref.row_top_k_ref(counts, r0, k)
        return ops.row_top_k(counts, r0, k)


def _block_topk(pidx: PackedIndex, rows: torch.Tensor,
                scope_mask: Optional[torch.Tensor], operands, r0: int, *,
                k: int, bm: int, method: str, shards=None):
    """Top-k neighbors of terms ``[r0, r0 + bm)``: (weights, ids), both
    (bm, k), weight -1 marking empty slots.  ``rows`` is the (V, W)
    transposed postings; rows past V have all-zero masks.  ``bm`` is a
    multiple of the row tile: one row block, or a group of them.  With
    ``shards`` the block's columns split across the mesh
    (:func:`~repro_torch.core.distributed.sharded_block_topk`, strategy
    ``"cols"``).  Without, ``"pallas"`` counts the block through kernel 3
    against the whole ``x_dense``: reached only under a mesh, through
    :func:`~repro_torch.core.distributed.sharded_row_block_topk`
    (strategy ``"rows"``, each shard's blocks on its device), since one
    device's ``"pallas"`` sweep is :func:`_compacted_sweep`.  While a
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
    return _row_top_k(counts, r0, k)


class _SweepPlan(NamedTuple):
    """Where each chunk of each row group's compacted operands comes from.
    Group ``g`` (terms ``[g * step, (g + 1) * step)``) counts over
    ``n_union[g]`` documents: those holding any of its terms (and in the
    scope), in ascending order, in chunks of :data:`DOC_CHUNK` of them.
    Its chunks are ``j`` in ``[first[g], first[g + 1])``; chunk ``j``
    holds ``n_docs[j]`` documents, K_pad = ``n_docs[j]`` rounded up to 16.
    ``a_flat[aoff[j]:][:n_a[j]]`` are the flat positions of the ones of
    its (rows, K_pad) operand, one a (doc, term) pair of the group's
    terms; ``b_flat[boff[j]:][:n_b[j]]`` those of its (V, K_pad) operand,
    one a (doc, term) pair of its documents.  Positions are int64 and
    relative to the chunk's operand.  The sizes are host arrays, read
    from the device once."""

    a_flat: torch.Tensor      # int64
    b_flat: torch.Tensor      # int64
    n_union: np.ndarray       # (G,) int64
    first: np.ndarray         # (G + 1,)
    n_docs: np.ndarray        # (J,) int64, one entry a chunk
    n_a: np.ndarray
    n_b: np.ndarray
    aoff: np.ndarray
    boff: np.ndarray


def _k_pad(n):
    """A compacted operand's doc axis: 16-byte rows, as TMA needs."""
    return (n + 15) // 16 * 16


def _chunk_geometry(i, n_union_of, chunk: int):
    """For the ``i``-th document of a group's union of ``n_union_of``:
    its chunk's K_pad and its column in that chunk's operands."""
    c0 = i - i % chunk
    return _k_pad(torch.clamp(n_union_of - c0, max=chunk)), i - c0


def _sweep_plan(fwd: ForwardIndex, scope_mask: Optional[torch.Tensor], *,
                step: int, n_groups: int) -> _SweepPlan:
    """Every row group's chunks and operand positions, from the forward
    index: one sort of the (doc, term) pairs by (group, doc), segment sums
    for the sizes of each (group, chunk), whose copy to the host is the
    only synchronise, then each chunk's documents' terms expanded, a
    chunk at a time.  Pairs outside the scope go to a group past the
    last, never read."""
    chunk = DOC_CHUNK
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
    del doc, grp
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    gid = key // cap
    uid = torch.cumsum(first, 0) - 1          # among all (group, doc)
    n_union = torch.zeros(n_groups + 1, dtype=torch.int64, device=dev)
    n_union.index_add_(0, gid, first.to(torch.int64))
    uoff = torch.cumsum(n_union, 0) - n_union
    i = uid - uoff[gid]                       # the doc's place in U_g
    kp, col = _chunk_geometry(i, n_union[gid], chunk)
    a_flat = (term[order] - gid * step) * kp + col
    del term, order, kp, col
    # sizes of each (group, chunk), row-major: the pairs' order
    per_group = -(-cap // chunk)
    gc = gid * per_group + i // chunk
    del i
    sizes = torch.zeros((3, (n_groups + 1) * per_group), dtype=torch.int64,
                        device=dev)
    sizes[0].index_add_(0, gc, first.to(torch.int64))
    sizes[1].index_add_(0, gc, torch.ones_like(gc))
    sizes[2].index_add_(0, gc, torch.where(first, lens[key - gid * cap], 0))
    # each (group, doc) once, in uid order: its doc
    udoc = torch.zeros_like(key).index_put_((uid,), key - gid * cap)
    del key, first, gid, uid, gc
    sizes = sizes[:, :n_groups * per_group].cpu().numpy()
    live = np.flatnonzero(sizes[0])
    n_docs, n_a, n_b = sizes[:, live]
    ustart, bstart = np.cumsum(n_docs) - n_docs, np.cumsum(n_b) - n_b
    # the (V, K_pad) ones, a chunk at a time: term t of the chunk's i-th
    # document
    b_flat = torch.empty((int(n_b.sum()),), dtype=torch.int64, device=dev)
    for u0, nu, b0, nb in zip(ustart.tolist(), n_docs.tolist(),
                              bstart.tolist(), n_b.tolist()):
        ud = udoc[u0:u0 + nu]
        ulen = lens[ud]
        rep = torch.repeat_interleave(torch.stack([
            fwd.ptr[ud] - (torch.cumsum(ulen, 0) - ulen),
            torch.arange(nu, device=dev)]), ulen, dim=1, output_size=nb)
        b_flat[b0:b0 + nb] = fwd.terms[rep[0] + torch.arange(
            nb, device=dev)].to(torch.int64) * _k_pad(nu) + rep[1]
    return _SweepPlan(a_flat, b_flat,
                      sizes[0].reshape(n_groups, per_group).sum(1),
                      np.searchsorted(live // per_group,
                                      np.arange(n_groups + 1)),
                      n_docs, n_a, n_b, np.cumsum(n_a) - n_a, bstart)


def _staged_block_topk(plan: _SweepPlan, g: int, abuf: torch.Tensor,
                       bbuf: torch.Tensor, r0: int, *, k: int, bm: int,
                       v: int):
    """:func:`_block_topk` of row group ``g`` over its own documents only,
    one kernel launch a chunk of them.  A chunk's operands are staged into
    the all-zero ``abuf`` and ``bbuf`` from the plan: (bm, K_pad) int8,
    entry (r, i) = 1 iff the chunk's i-th document holds term ``r0 + r``,
    and (V, K_pad) int8, entry (t, i) = 1 iff it holds ``t``; the kernel
    counts over K_pad, its int32 counts are added to the previous
    chunks', and the ones are cleared after it.  One top-k follows the
    last chunk.  A group with no documents launches nothing and emits no
    edge.  Spans: ``cooc.materialize.chunk`` around each chunk (attrs
    ``r0``, ``c0``, its first document in the union, and ``docs``), the
    group's one ``cooc.materialize.masks`` (attr ``docs``, the union)
    around its first chunk's staging, and ``cooc.materialize.count``
    around each launch, its add and the clearing."""
    n = int(plan.n_union[g])
    dev = abuf.device
    if n == 0:
        with tracing.span("cooc.materialize.masks", r0=r0, docs=0):
            return (torch.full((bm, k), -1, dtype=torch.int32, device=dev),
                    torch.zeros((bm, k), dtype=torch.int64, device=dev))
    counts = None
    c0 = 0
    for j in range(plan.first[g], plan.first[g + 1]):
        nd = int(plan.n_docs[j])
        kp = _k_pad(nd)
        with tracing.span("cooc.materialize.chunk", r0=r0, c0=c0, docs=nd):
            with (tracing.span("cooc.materialize.masks", r0=r0, docs=n)
                  if c0 == 0 else tracing.NO_SPAN):
                fa = plan.a_flat[plan.aoff[j]:][:plan.n_a[j]]
                fb = plan.b_flat[plan.boff[j]:][:plan.n_b[j]]
                abuf.index_fill_(0, fa, 1)
                bbuf.index_fill_(0, fb, 1)
            with tracing.span("cooc.materialize.count"):
                part = ops.cooccur_counts(abuf[:bm * kp].view(bm, kp).t(),
                                          bbuf[:v * kp].view(v, kp).t())
                counts = part if counts is None else counts.add_(part)
                abuf.index_fill_(0, fa, 0)
                bbuf.index_fill_(0, fb, 0)
        c0 += nd
    return _row_top_k(counts, r0, k)


def _compacted_sweep(pidx: PackedIndex, ctx: Optional[QueryContext],
                     scope_mask: Optional[torch.Tensor], *, k: int, bm: int):
    """The single-device exact ``"pallas"`` sweep: one top-k a group of
    :data:`GROUP` row blocks, each counted over the group's own documents
    in chunks (:func:`_staged_block_topk`).  The forward index, and the
    unscoped plan, are the context's epoch artifacts.  The staging
    buffers are sized by the largest chunk and freed at the end.  Returns
    the (n_rows, k) weights and ids."""
    v = pidx.vocab_size
    n_rows = _round_up(v, bm)
    step = GROUP * bm
    n_groups = -(-n_rows // step)
    plan_key = ("materialize", "plan", step, DOC_CHUNK)
    plan = (ctx.cached_artifact(plan_key, version=0)
            if ctx is not None and scope_mask is None else None)
    if plan is None:
        fwd = ctx.forward_index() if ctx is not None else forward_index(pidx)
        plan = _sweep_plan(fwd, scope_mask, step=step, n_groups=n_groups)
        if ctx is not None and scope_mask is None:
            ctx.store_artifact(plan_key, plan, version=0)
    k_max = int(_k_pad(plan.n_docs).max()) if len(plan.n_docs) else 0
    abuf = torch.zeros((step * k_max,), dtype=torch.int8, device=pidx.device)
    bbuf = torch.zeros((v * k_max,), dtype=torch.int8, device=pidx.device)
    ws, ids = [], []
    for g, r0 in enumerate(range(0, n_rows, step)):
        w_b, i_b = _staged_block_topk(plan, g, abuf, bbuf, r0, k=k,
                                      bm=min(step, n_rows - r0), v=v)
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
    with ``method="pallas"`` on one device it is one group's GROUP x
    (row_tile, V) int32 counts twice, the running sum and one chunk's
    (134 MB each at the CSL scale, GROUP = 4 and row_tile = 128), and the
    sweep's staging buffers, (GROUP * row_tile + V) int8 bytes a document
    of the largest chunk: at most :data:`DOC_CHUNK` documents, whatever
    the corpus (8.7 GB at 65,536 terms).  The plan the sweep stages from
    is held per epoch beside the forward index: 8 bytes a (doc, term)
    pair, and 8 more for each group that the pair's document is in the
    union of.

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
        run_w, run_i = _compacted_sweep(pidx, ctx, scope_mask, k=k, bm=bm)
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
