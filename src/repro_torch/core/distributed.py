"""Device-mesh sharded query execution (the scale-out axis), in PyTorch.

Mirrors ``repro.core.distributed``.  The reference's mesh is
single-controller: one process drives a 2-D ``("data", "model")`` mesh,
and each sharded function is one ``shard_map`` whose merge is an
``all_gather``, a ``psum`` or a ``pmin``.  Here the same thing runs in one
process over a :class:`CoocMesh` of torch devices: each shard's operands
live on its device, the shard's kernels launch there, and the partial
results merge onto the mesh's first device, in shard order.

* **Term sharding** (``shard="terms"``, the "model" axis): the packed
  postings ``(W, V)`` split on the vocabulary axis into contiguous column
  ranges.  Each shard counts the frontier against ITS columns and the
  partials concatenate (:func:`sharded_counts`), or each shard reduces to
  a local top-k and only the candidates merge (:func:`sharded_level_topk`,
  :func:`sharded_block_topk`).
* **Doc sharding** (``shard="docs"``, the "data" axis): the packed word
  rows split into contiguous ranges; each shard popcounts its documents
  and the int32 partial counts sum, exact since integer addition is
  associative.

Every sharded path gives the single-device result bit for bit, values and
tie order: counts are exact integers, shards are contiguous id ranges
merged in shard order, each local top-k emits lower ids first on ties, and
the final top-k prefers earlier candidate slots, so the merged order is
the single-device ``lax.top_k`` order.  A shard's local top-k keeps only
its real columns (none of the reference's padding columns): they could
never be chosen by the merge, and without them the merged result equals
the single device's even where ``k`` exceeds what a row can fill.

**Layout.**  A term shard holds ``ceil(V / n)`` columns rounded up to a
multiple of 8 (the int8 GEMM's column quantum, so that a shard's columns
of the dense incidence are a view); the last shards may be short or empty.
A doc shard holds ``ceil(W / n)`` word rows (32 doc slots each, so a shard
of the dense incidence starts 16-byte aligned).  A device may repeat in a
mesh (``make_cooc_mesh(devices=["cuda:0"] * 4)``): its shards then run one
after another on that device, which is how one card, or the CPU, runs a
many-shard mesh.

**The shard artifact.**  :class:`ShardedIndex` holds one (index, mesh)
pair's per-shard operands: a term shard's postings columns copied once into
a contiguous (W, V/n) block (the postings and level-step kernels read
(W, V) row-major), a doc shard's word rows as a view, and on a mesh of
several devices the copies each device needs.  ``QueryContext`` caches it
per epoch (:meth:`~repro_torch.core.query_context.QueryContext.
mesh_shards`), so an ingest rebuilds it once and a query never does.

What each shard launches on a card: ``"pallas"`` the postings kernel,
``"fused"`` the level-step kernel under a term mesh (one launch a level per
shard) and the postings kernel under a doc mesh, ``"gemm"``
``torch._int_mm``, ``"popcount"`` its plain version (by design, as on one
device), and whole-network materialization the co-occurrence kernel.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.inverted_index import PackedIndex, unpack_bitmap
from repro_torch.core.query import get_count_method
from repro_torch.device import canonical_device, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_lower_index

#: mesh axes (the reference's launch/mesh.py convention): docs split over
#: "data", terms over "model"
DOC_AXIS = "data"
TERM_AXIS = "model"

#: a term shard's width is a multiple of this many columns
TERM_QUANTUM = 8


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


# ---------------------------------------------------------------------------
# Mesh construction / validation
# ---------------------------------------------------------------------------


class CoocMesh:
    """A query mesh: a ``(data, model)`` grid of torch devices, driven by
    one process.  Frozen; two meshes are equal when their shapes and
    device positions are."""

    __slots__ = ("devices", "axis_names")

    def __init__(self, devices, axis_names: Sequence[str] = (DOC_AXIS,
                                                              TERM_AXIS)):
        src = np.asarray(devices, dtype=object)
        if src.ndim != 2 or len(tuple(axis_names)) != 2 or src.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D grid of devices "
                             f"with two axis names, got shape {src.shape} "
                             f"and axes {tuple(axis_names)}")
        grid = np.empty(src.shape, dtype=object)
        for pos in np.ndindex(grid.shape):
            grid[pos] = canonical_device(src[pos])
        grid.setflags(write=False)
        object.__setattr__(self, "devices", grid)
        object.__setattr__(self, "axis_names", tuple(axis_names))

    def __setattr__(self, name, value):
        raise AttributeError("CoocMesh is frozen")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def key(self) -> Tuple:
        """What tells two meshes apart: the grid's shape and every device
        position (two shards on ``cuda:0`` are not four)."""
        return (self.axis_names, tuple(self.devices.shape),
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, CoocMesh) and self.key == other.key

    def __hash__(self) -> int:
        return hash(self.key)

    def __repr__(self) -> str:
        return (f"CoocMesh({self.shape}, "
                f"[{', '.join(str(d) for d in self.devices.flat)}])")


def make_cooc_mesh(n_shards: Optional[int] = None, *,
                   devices: Optional[Sequence] = None,
                   shard: str = "terms") -> CoocMesh:
    """A query-serving mesh over ``n_shards`` devices (default: all).

    shard="terms" -> ("data"=1, "model"=n): postings columns split.
    shard="docs"  -> ("data"=n, "model"=1): packed word rows split.

    ``devices`` defaults to every visible CUDA device (with no card it
    raises, as the port's entry points do).  A device may repeat:
    ``devices=["cpu"] * 4`` is a four-shard mesh on the CPU."""
    if shard not in ("terms", "docs"):
        raise ValueError(f"shard must be 'terms' or 'docs', got {shard!r}")
    if devices is None:
        resolve_device("cuda")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = list(devices)
    if n_shards is not None:
        if n_shards < 1 or n_shards > len(devs):
            raise ValueError(f"n_shards={n_shards} outside [1, {len(devs)}] "
                             "available devices")
        devs = devs[:n_shards]
    n = len(devs)
    shape = (1, n) if shard == "terms" else (n, 1)
    grid = np.empty(shape, dtype=object)
    for i, d in enumerate(devs):
        grid.flat[i] = d
    return CoocMesh(grid, (DOC_AXIS, TERM_AXIS))


def validate_mesh(mesh: CoocMesh) -> None:
    """Reject meshes the sharded paths can't serve (both axes > 1, or
    missing the ("data", "model") axis names)."""
    if not isinstance(mesh, CoocMesh):
        raise TypeError(f"mesh must be a CoocMesh (build one with "
                        f"make_cooc_mesh), got {type(mesh).__name__}")
    for ax in (DOC_AXIS, TERM_AXIS):
        if ax not in mesh.shape:
            raise ValueError(
                f"mesh axes {tuple(mesh.shape)} miss {ax!r}; build one with "
                "make_cooc_mesh (axes ('data', 'model'))")
    if mesh.shape[DOC_AXIS] > 1 and mesh.shape[TERM_AXIS] > 1:
        raise ValueError(
            f"mesh shards BOTH docs ({mesh.shape[DOC_AXIS]}) and terms "
            f"({mesh.shape[TERM_AXIS]}); the query paths shard one axis "
            "at a time — use make_cooc_mesh(shard='terms'|'docs')")


def shard_kind(mesh: CoocMesh) -> str:
    """'docs' when the data axis carries the split, else 'terms' (a 1x1
    mesh degenerates to a single-shard 'terms' layout)."""
    validate_mesh(mesh)
    return "docs" if mesh.shape[DOC_AXIS] > 1 else "terms"


def n_shards(mesh: CoocMesh) -> int:
    return max(mesh.shape[DOC_AXIS], mesh.shape[TERM_AXIS])


def mesh_device(mesh: CoocMesh) -> torch.device:
    """The mesh's first device, where its merged results land.  A mesh
    must not mix CPU and CUDA devices: a CUDA mesh never routes a shard
    through a kernel's plain version."""
    validate_mesh(mesh)
    kinds = {d.type for d in mesh.devices.flat}
    if len(kinds) > 1:
        raise ValueError(f"mesh mixes device types {sorted(kinds)}; a mesh "
                         "is all CUDA devices or all CPU")
    return mesh.devices.flat[0]


# ---------------------------------------------------------------------------
# The shard artifact
# ---------------------------------------------------------------------------


def shard_ranges(size: int, n: int, quantum: int = 1
                 ) -> List[Tuple[int, int]]:
    """The layout of every sharded operand: ``n`` contiguous ``[lo, hi)``
    ranges over ``size`` items, each ``ceil(size / n)`` rounded up to a
    multiple of ``quantum``; the last ranges may be short or empty."""
    loc = _round_up(-(-size // n), quantum)
    return [(min(s * loc, size), min((s + 1) * loc, size)) for s in range(n)]


class Shard(NamedTuple):
    device: torch.device
    lo: int      # first global column (terms) or word row (docs)
    hi: int      # one past the last


def _placed(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev``: itself when it is there, else a copy.  A 2-D view
    whose first axis is the contiguous one (the ``.t()`` view of
    term-major storage, as ``x_dense`` is) stays so."""
    if x.device == dev:
        return x
    if x.dim() == 2 and x.stride(0) == 1 and x.stride(1) != 1:
        return x.t().contiguous().to(dev).t()
    return x.contiguous().to(dev)


class ShardedIndex:
    """One (index, mesh) pair's per-shard operands (see the module
    docstring).  ``parts[s]`` is shard ``s``'s local
    :class:`~repro_torch.core.inverted_index.PackedIndex` on its device:
    under a term mesh the shard's postings columns (a contiguous copy) and
    their doc frequencies; under a doc mesh its word rows and the global
    doc frequencies."""

    def __init__(self, index: PackedIndex, mesh: CoocMesh):
        self.mesh = mesh
        self.kind = shard_kind(mesh)
        self.n = n_shards(mesh)
        self.device = mesh_device(mesh)
        if index.device != self.device:
            index = PackedIndex(index.packed.to(self.device),
                                index.doc_freq.to(self.device),
                                int(index.n_docs))
        self.index = index
        ranges = (shard_ranges(index.vocab_size, self.n, TERM_QUANTUM)
                  if self.kind == "terms"
                  else shard_ranges(index.n_words, self.n))
        self.shards: List[Shard] = [
            Shard(d, lo, hi)
            for d, (lo, hi) in zip(mesh.devices.flat, ranges)]
        self.parts: List[PackedIndex] = []
        for sh in self.shards:
            if self.kind == "terms":
                packed = index.packed[:, sh.lo:sh.hi].contiguous()
                df = index.doc_freq[sh.lo:sh.hi]
            else:
                packed = index.packed[sh.lo:sh.hi]
                df = index.doc_freq
            self.parts.append(PackedIndex(_placed(packed, sh.device),
                                          _placed(df, sh.device),
                                          int(index.n_docs)))
        self._x: Optional[Tuple[torch.Tensor, list]] = None
        self._copies: Dict[Tuple[int, str], Tuple[torch.Tensor,
                                                   torch.Tensor]] = {}

    @property
    def vocab_size(self) -> int:
        return self.index.vocab_size

    def x_shards(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Each shard's part of the dense incidence ``x`` (D, V_pad), on
        its device: a term shard's columns (its width rounded up to 8, so
        the int8 GEMM takes them), a doc shard's doc rows.  Views on the
        index's device, one copy per shard elsewhere; kept while ``x`` is
        the operand passed."""
        if self._x is None or self._x[0] is not x:
            parts = []
            for sh in self.shards:
                if self.kind == "terms":
                    view = x[:, sh.lo:sh.lo + _round_up(sh.hi - sh.lo,
                                                        TERM_QUANTUM)]
                else:
                    view = x[sh.lo * 32:sh.hi * 32]
                parts.append(_placed(view, sh.device))
            self._x = (x, parts)
        return self._x[1]

    def placed(self, x: Optional[torch.Tensor],
               dev: torch.device) -> Optional[torch.Tensor]:
        """``x`` on ``dev``, copied there at most once for this artifact
        (the whole-index operands of ``shard_strategy="rows"``: one copy
        per distinct device, however many shards it holds)."""
        if x is None or x.device == dev:
            return x
        key = (id(x), str(dev))
        ent = self._copies.get(key)
        if ent is None or ent[0] is not x:
            ent = (x, _placed(x, dev))
            self._copies[key] = ent
        return ent[1]


def shard_index(index, mesh: Optional[CoocMesh] = None) -> ShardedIndex:
    """The shard artifact of ``index`` over ``mesh``: a QueryContext's
    epoch-cached one, a :class:`ShardedIndex` over the same mesh as it
    is, or a one-shot build over a bare PackedIndex."""
    from repro_torch.core.query_context import QueryContext
    if isinstance(index, ShardedIndex):
        if mesh is None or index.mesh == mesh:
            return index
        index = index.index
    if isinstance(index, QueryContext):
        return index.mesh_shards(mesh)
    if mesh is None:
        raise ValueError("a bare index needs an explicit mesh")
    return ShardedIndex(index, mesh)


# ---------------------------------------------------------------------------
# Per-shard counts
# ---------------------------------------------------------------------------


def _needs(method: str, cooc_gemm: bool) -> Tuple[str, ...]:
    if cooc_gemm and method == "pallas":
        return ("x_dense",)
    return get_count_method(method).needs


def _local_counts(method: str, cooc_gemm: bool, index_l: PackedIndex,
                  masks: torch.Tensor, x_l: Optional[torch.Tensor],
                  left: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One shard's (B, V_local) counts.  ``cooc_gemm`` routes method
    "pallas" through the co-occurrence kernel over the shard's part of
    the dense incidence ``x_l`` (materialization's kernel) instead of the
    postings kernel the frontier registry uses; its left operand is the
    masks unpacked (``left``, when the caller unpacked them once for
    every shard)."""
    v = index_l.vocab_size
    if cooc_gemm and method == "pallas":
        if left is None:
            left = unpack_bitmap(masks, torch.int8).t()
        return ops.cooccur_counts(left, x_l)[:, :v]
    from repro_torch.core.query_context import pad_transposed
    m = get_count_method(method)
    build = {"x_dense": lambda: x_l,
             "packed_t": lambda: index_l.packed.T.contiguous(),
             "packed_t_pad": lambda: pad_transposed(index_l.packed)}
    return m.fn(index_l, masks, {n: build[n]() for n in m.needs})[:, :v]


def _shard_masks(sh: ShardedIndex, s: int, masks: torch.Tensor
                 ) -> torch.Tensor:
    """Shard ``s``'s frontier masks: all words under a term mesh, its
    word rows under a doc mesh."""
    shard = sh.shards[s]
    if sh.kind == "docs":
        masks = masks[:, shard.lo:shard.hi]
    return masks.to(shard.device)


def _each_shard(sh: ShardedIndex, masks: torch.Tensor, method: str,
                operands: Mapping[str, torch.Tensor], cooc_gemm: bool):
    """(shard number, shard, its counts) for every non-empty shard."""
    x = (sh.x_shards(operands["x_dense"])
         if "x_dense" in _needs(method, cooc_gemm) else None)
    # a term mesh's shards share one left operand of the co-occurrence
    # kernel: unpack the masks once
    left = (unpack_bitmap(masks, torch.int8).t()
            if cooc_gemm and method == "pallas" and sh.kind == "terms"
            else None)
    for s, shard in enumerate(sh.shards):
        if shard.hi == shard.lo:
            continue
        yield s, shard, _local_counts(
            method, cooc_gemm, sh.parts[s], _shard_masks(sh, s, masks),
            x[s] if x is not None else None,
            _placed(left, shard.device) if left is not None else None)


def sharded_counts(index, masks: torch.Tensor, method: str,
                   operands: Mapping[str, torch.Tensor], mesh: CoocMesh, *,
                   cooc_gemm: bool = False) -> torch.Tensor:
    """(B, V) int32 frontier counts under ``mesh``, on its first device,
    bit-exact against the single-device method.

    Term mesh: each shard counts against its postings columns and the
    partials concatenate in shard order.  Doc mesh: each shard popcounts
    its word rows and the int32 partials sum.  ``index`` is a PackedIndex,
    a QueryContext or a :class:`ShardedIndex`."""
    sh = shard_index(index, mesh)
    parts = [c.to(sh.device) for _, _, c in
             _each_shard(sh, masks, method, operands, cooc_gemm)]
    if sh.kind == "terms":
        return torch.cat(parts, dim=1)
    out = parts[0]
    for c in parts[1:]:
        out = out + c
    return out


# ---------------------------------------------------------------------------
# Sharded MinHash signatures (the approximate-materialization sketch)
# ---------------------------------------------------------------------------


def sharded_signatures(packed: torch.Tensor, a, b, mesh: CoocMesh, *,
                       perm_tile: int = 16) -> torch.Tensor:
    """Per-term MinHash signatures (V, P), int32 uint32 patterns, under
    ``mesh`` — bit-exact against
    :func:`repro_torch.core.sketch.minhash_signatures`.

    Term mesh: each shard hashes its postings columns against the global
    slot keys and the (V/n, P) results concatenate.  Doc mesh: each shard
    hashes its word rows with keys offset to its first slot (its first
    word times 32) and the partial signatures merge by an
    unsigned minimum, exact in any order (a shard without a posting of a
    term holds ``SIG_EMPTY`` for it, the identity)."""
    from repro_torch.core.sketch import _umin, signatures_from_packed
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a, np.uint32)
    b = np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b, np.uint32)
    n = n_shards(mesh)
    dev0 = mesh_device(mesh)
    w, v = packed.shape
    devs = list(mesh.devices.flat)
    if shard_kind(mesh) == "terms":
        return torch.cat([
            signatures_from_packed(_placed(packed[:, lo:hi], dev), a, b,
                                   perm_tile=perm_tile).to(dev0)
            for dev, (lo, hi) in zip(devs, shard_ranges(v, n, TERM_QUANTUM))
            if hi > lo])
    out = None
    for dev, (lo, hi) in zip(devs, shard_ranges(w, n)):
        if hi > lo:
            sig = signatures_from_packed(_placed(packed[lo:hi], dev), a, b,
                                         slot0=lo * 32,
                                         perm_tile=perm_tile).to(dev0)
            out = sig if out is None else _umin(out, sig)
    return out


# ---------------------------------------------------------------------------
# Sharded top-k: materialization's row blocks and the BFS level
# ---------------------------------------------------------------------------


def _merge_topk(sh: ShardedIndex, ws: List[torch.Tensor],
                ids: List[torch.Tensor], k: int):
    """The candidate merge: shard-major (weights, global ids) buffers ->
    their top-``k`` in ``lax.top_k`` order, padded to ``k`` with weight
    -1 / id 0 when the vocabulary is smaller (as ``chunked_top_k``)."""
    w_all = torch.cat(ws, dim=1)
    i_all = torch.cat(ids, dim=1)
    k_eff = min(k, sh.vocab_size)
    w2, sel = topk_lower_index(w_all, k_eff)
    i2 = torch.gather(i_all, 1, sel)
    if k_eff < k:
        w2 = torch.nn.functional.pad(w2, (0, k - k_eff), value=-1)
        i2 = torch.nn.functional.pad(i2, (0, k - k_eff), value=0)
    return w2, i2


def sharded_block_topk(index, masks: torch.Tensor, rows: torch.Tensor,
                       operands: Mapping[str, torch.Tensor], *, k: int,
                       method: str, mesh: CoocMesh, cooc_gemm: bool = True):
    """Top-``k`` neighbors of one materialization row block under
    ``mesh``: (weights, ids), both (bm, k), weight -1 marking empty slots
    — the values and tie order of the single-device block
    (``materialize._block_topk``).  ``rows`` (bm,) are the rows' own
    column ids (their self-pairs are masked; an id matching no column
    masks nothing).

    Term mesh: each shard reduces its columns to a local top-k and only
    the ``n * k`` candidates merge — the (bm, V) count block is never
    assembled.  Doc mesh: summed counts through the single-device
    ``chunked_top_k``.  ``cooc_gemm`` (the default, the reference's
    choice) counts "pallas" through the co-occurrence kernel; the
    approximate sweep passes False to count its gathered candidate tiles
    through the postings kernel, as it does on one device."""
    from repro_torch.core.cooccurrence import chunked_top_k
    sh = shard_index(index, mesh)
    if sh.kind == "docs":
        counts = sharded_counts(sh, masks, method, operands, mesh,
                                cooc_gemm=cooc_gemm)
        cols = torch.arange(counts.shape[1], device=counts.device)
        counts = torch.where(cols[None, :] == rows.to(counts.device)[:, None],
                             -1, counts)
        return chunked_top_k(counts, k)
    ws, ids = [], []
    for s, shard, c in _each_shard(sh, masks, method, operands, cooc_gemm):
        cols = torch.arange(c.shape[1], device=c.device)
        local = rows.to(c.device)[:, None] - shard.lo
        c = torch.where(cols[None, :] == local, -1, c)
        w_l, i_l = topk_lower_index(c, min(k, c.shape[1]))
        ws.append(w_l.to(sh.device))
        ids.append(i_l.to(sh.device) + shard.lo)
    return _merge_topk(sh, ws, ids, k)


def sharded_level_topk(index, masks: torch.Tensor, terms: torch.Tensor,
                       valid: torch.Tensor, visited: torch.Tensor,
                       method: str, operands: Mapping[str, torch.Tensor],
                       mesh: CoocMesh, *, k: int, dedup: bool):
    """One BFS level's (weights, ids), both (R, k), under ``mesh`` —
    bit-identical, values and tie order, to the single-device
    counts -> masks -> ``chunked_top_k`` chain.  ``visited`` is (V,) for
    one query or (Q, V) for a batch-major frontier of Q queries (row r
    belongs to query ``r // (R // Q)``).

    Term mesh: each shard counts against its columns, applies every level
    mask locally (self-pair, visited, invalid rows) and reduces to a local
    top-k; only the candidates merge.  A method with a fused ``level_fn``
    (``"fused"``: the level-step kernel) runs it once per shard on the
    shard's postings, so the counts, masks and local top-k stay in one
    launch; the shard sees its own column ids, and a row's term outside
    the shard is mapped past the shard's width, where it masks nothing.
    Doc mesh: summed counts, then the single-device masks and
    ``chunked_top_k``."""
    from repro_torch.core.cooccurrence import chunked_top_k, mask_level
    sh = shard_index(index, mesh)
    vis = visited if visited.dim() == 2 else visited[None, :]
    rows_per_query = masks.shape[0] // vis.shape[0]
    k_eff = min(k, sh.vocab_size)
    if sh.kind == "docs":
        counts = sharded_counts(sh, masks, method, operands, mesh)
        c = mask_level(counts, terms, valid,
                       vis.repeat_interleave(rows_per_query, dim=0)
                       if dedup else None)
        w2, i2 = chunked_top_k(c, k)
        return w2, i2
    m = get_count_method(method)
    x = (sh.x_shards(operands["x_dense"]) if "x_dense" in m.needs
         else None)
    ws, ids = [], []
    for s, shard in enumerate(sh.shards):
        width = shard.hi - shard.lo
        if width == 0:
            continue
        dev = shard.device
        local = terms.to(dev) - shard.lo
        local = torch.where((local >= 0) & (local < width), local, width)
        valid_l = valid.to(dev)
        vis_l = vis[:, shard.lo:shard.hi].to(dev)
        masks_l = masks.to(dev)
        kk = min(k_eff, width)
        if m.level_fn is not None:
            w_l, i_l = m.level_fn(sh.parts[s], masks_l, local, valid_l,
                                  vis_l, {}, k=kk, dedup=dedup)
        else:
            c = _local_counts(method, False, sh.parts[s], masks_l,
                              x[s] if x is not None else None)
            c = mask_level(c, local, valid_l,
                           vis_l.repeat_interleave(rows_per_query, dim=0)
                           if dedup else None)
            w_l, i_l = topk_lower_index(c, kk)
        ws.append(w_l.to(sh.device).to(torch.int32))
        ids.append(i_l.to(sh.device).to(torch.int64) + shard.lo)
    return _merge_topk(sh, ws, ids, k)


# ---------------------------------------------------------------------------
# Row-sharded materialization (each shard a contiguous range of row blocks)
# ---------------------------------------------------------------------------


def sharded_row_block_topk(index, packed_t: torch.Tensor,
                           scope_mask: Optional[torch.Tensor],
                           operands: Mapping[str, torch.Tensor], *, k: int,
                           bm: int, method: str, mesh: CoocMesh):
    """Materialization strategy "rows": each shard walks a contiguous
    range of the row blocks against the whole index, held once on each
    distinct device of the mesh, and the (rows, k) results concatenate in
    shard order, which is global row order.  Returns (weights, ids), both
    (n_rows, k) with ``n_rows >= V`` (rows past V are the caller's to
    slice off).  Each block is the single-device block
    (``materialize._block_topk``, ``GROUP`` row blocks a launch under
    "pallas"), so values and tie order are its own; there is no
    cross-shard reduction at all.  ``packed_t`` holds the (V, W) mask
    rows."""
    from repro_torch.core.materialize import GROUP, _block_topk
    sh = shard_index(index, mesh)
    step = GROUP * bm if method == "pallas" else bm
    ws, ids = [], []
    for shard, (b0, b1) in zip(sh.shards,
                               shard_ranges(-(-sh.vocab_size // bm), sh.n)):
        dev = shard.device
        pidx = PackedIndex(sh.placed(sh.index.packed, dev),
                           sh.placed(sh.index.doc_freq, dev),
                           sh.index.n_docs)
        rows = sh.placed(packed_t, dev)
        scope = sh.placed(scope_mask, dev)
        ops_d = {name: sh.placed(t, dev) for name, t in operands.items()}
        for r0 in range(b0 * bm, b1 * bm, step):
            w_b, i_b = _block_topk(pidx, rows, scope, ops_d, r0, k=k,
                                   bm=min(step, b1 * bm - r0), method=method)
            ws.append(w_b.to(sh.device))
            ids.append(i_b.to(sh.device))
    return torch.cat(ws), torch.cat(ids)
