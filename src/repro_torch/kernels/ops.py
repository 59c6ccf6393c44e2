"""Public kernel wrappers: the device of the operands picks the path.

A CUDA tensor goes to the hand-written kernel (built at first use, see
:mod:`repro_torch.kernels.build`); a CPU tensor goes to the kernel's plain
version in :mod:`repro_torch.kernels.ref`.  There is no other path and no
fallback: a kernel that fails to build or launch raises.

:data:`LAUNCHES` counts the kernel launches of each wrapper (a wrapper adds
one where it launches its kernel and nowhere else), so a run can show that
its main path went through the kernels.  It is process-wide on purpose: it
counts the launches of the process's one set of kernels, from any thread
(the server's lanes step from executor threads), so every update holds
:data:`_COUNTS_LOCK`.

A ``meta`` tensor (the launch layer's placeholder) reaches neither a
launch nor a plain version: the wrapper returns an output of the right
shape and dtype.  Where a wrapper launches its kernel, or stands in for
it on ``meta``, it charges the launch's operations and bytes
(:func:`kernel_cost`) to the active cost sinks, the launch layer's
counters (:class:`repro_torch.launch.roofline.Counter`): the kernels are
called through ``ctypes``, so PyTorch's dispatch never sees them.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.row_topk import MAX_K as ROW_TOPK_MAX_K

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"postings_counts": 0, "level_step": 0,
                             "cooccur_counts": 0, "dot_interaction": 0,
                             "flash_decode": 0, "row_topk": 0}
#: the co-occurrence launches by the path the kernel reports it took:
#: ``"tma"`` (wgmma fed by TMA, the main path) or ``"bytes"`` (the
#: mma.sync fallback for operands TMA cannot describe)
COOCCUR_PATHS: Dict[str, int] = {"tma": 0, "bytes": 0}
_COUNTS_LOCK = threading.Lock()
#: the counters a launch is charged to (see :func:`add_cost_sink`)
_COST_SINKS: List = []


def reset_launches() -> None:
    with _COUNTS_LOCK:
        for counts in (LAUNCHES, COOCCUR_PATHS):
            for name in counts:
                counts[name] = 0


def _count(name: str, path: Optional[str] = None) -> None:
    """One launch of ``name`` (and of the co-occurrence ``path``)."""
    with _COUNTS_LOCK:
        LAUNCHES[name] += 1
        if path is not None:
            COOCCUR_PATHS[path] += 1


def add_cost_sink(sink) -> None:
    """Charge every launch from now on to ``sink.charge(name, n_ops,
    n_bytes)`` as well, until :func:`remove_cost_sink`."""
    with _COUNTS_LOCK:
        _COST_SINKS.append(sink)


def remove_cost_sink(sink) -> None:
    with _COUNTS_LOCK:
        _COST_SINKS.remove(sink)


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_cost(name: str, *args: torch.Tensor, **kw) -> Tuple[int, int]:
    """(operations, bytes) of one launch of kernel ``name`` on its
    operands (tensors or ``meta`` placeholders), each input read once and
    each output written once: the counts of ``PERF.md``'s kernel table,
    taken dense.  Kernels 1 and 2 count every mask word against every
    column (one AND+popcount each) and every packed word row, where the
    table's bound counts only the nonzero words the data has: a count on
    ``meta`` has no data.

    postings_counts(masks, packed) / level_step(masks, packed, terms,
    valid, visited, v=, k=) / cooccur_counts(x_l, x_r) /
    dot_interaction(x) / flash_decode(q, k, v) / row_topk(counts, k=):
    one comparison a count."""
    if name == "postings_counts":
        masks, packed = args
        (r, w), v = masks.shape, packed.shape[1]
        return r * w * v, _nbytes(masks, packed) + r * v * 4
    if name == "level_step":
        masks, packed, terms, valid, visited = args
        (r, w), v, k = masks.shape, kw["v"], kw["k"]
        return (r * w * v, _nbytes(masks, terms, valid, visited)
                + w * v * 4 + 2 * r * k * 4)
    if name == "cooccur_counts":
        x_l, x_r = args
        d, vl, vr = x_l.shape[0], x_l.shape[1], x_r.shape[1]
        return 2 * d * vl * vr, _nbytes(x_l, x_r) + vl * vr * 4
    if name == "dot_interaction":
        x, = args
        b, f, e = x.shape
        p = f * (f - 1) // 2
        return 2 * b * p * e, (b * f * e + b * p) * x.element_size()
    if name == "flash_decode":
        q, k, v = args
        b, hq, d = q.shape
        s = k.shape[1]
        return 4 * b * hq * s * d, 2 * _nbytes(q, k) + b * 4
    if name == "row_topk":
        counts, = args
        r, v = counts.shape
        return r * v, _nbytes(counts) + r * kw["k"] * (4 + 8)
    raise KeyError(name)


def _charge(name: str, *args: torch.Tensor, **kw) -> None:
    """Charge one launch (or its ``meta`` stand-in) to the cost sinks."""
    if not _COST_SINKS:            # the serving path: nothing counts
        return
    with _COUNTS_LOCK:
        sinks = list(_COST_SINKS)
    if sinks:
        n_ops, n_bytes = kernel_cost(name, *args, **kw)
        for sink in sinks:
            sink.charge(name, n_ops, n_bytes)


def _is_meta(x: torch.Tensor) -> bool:
    return x.device.type == "meta"


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"kernels run on cuda (hand-written) or cpu (plain "
                     f"version), not {x.device}")


def postings_counts(masks: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """counts[b, v] = sum_w popcount(masks[b, w] & packed[w, v]).

    masks (B, W), packed (W, V): int32 tensors holding uint32 bit patterns
    -> (B, V) int32.  Mirrors ``repro.kernels.ops.postings_counts``."""
    if _is_meta(masks):
        _charge("postings_counts", masks, packed)
        return masks.new_empty((masks.shape[0], packed.shape[1]))
    if _on_cuda(masks):
        from repro_torch.kernels.postings import postings_counts_cuda
        out = postings_counts_cuda(masks, packed)
        _count("postings_counts")
        _charge("postings_counts", masks, packed)
        return out
    return ref.postings_counts_ref(masks, packed)


def level_step(masks: torch.Tensor, packed: torch.Tensor,
               terms: torch.Tensor, valid: torch.Tensor,
               visited: torch.Tensor, *, v: int, k: int, dedup: bool = True):
    """One fused BFS level step: popcount counts + self/visited/valid
    masking + exact top-k.  Mirrors ``repro.kernels.ops.level_step``.

    masks (R, W) int32; packed (W, V) int32 with V >= v, the index's own
    postings (``PackedIndex.packed``, the operand of
    :func:`postings_counts`; the reference takes their padded transpose,
    ``packed_t_pad``, and the results are identical: columns past ``v``
    are padding either way); terms (R,) int32 (-1 = invalid); valid (R,)
    bool; visited (V,) bool for one query, or (Q, V) bool for a
    batch-major frontier whose row r belongs to query ``r // (R // Q)``.
    Returns (weights, ids), both (R, k) int32, in exact ``lax.top_k``
    order; ``k > v`` clamps and pads the missing slots with weight -1 /
    id 0.  Nothing is padded or transposed per call.
    """
    w, vp = packed.shape
    if masks.shape[1] != w or vp < v:
        raise ValueError(
            f"packed {tuple(packed.shape)} is not the (W, V) postings of "
            f"masks {tuple(masks.shape)} with V >= v={v}; pass the index's "
            "packed (W, V) bitmap")
    vis = visited if visited.dim() == 2 else visited[None, :]
    if masks.shape[0] % vis.shape[0]:
        raise ValueError(f"{masks.shape[0]} frontier rows do not split into "
                         f"{vis.shape[0]} queries")
    k_eff = min(k, v)
    if _is_meta(masks):
        _charge("level_step", masks, packed, terms, valid, vis, v=v, k=k_eff)
        w = masks.new_empty((masks.shape[0], k_eff))
        i = masks.new_empty((masks.shape[0], k_eff))
    elif _on_cuda(masks):
        from repro_torch.kernels.level_step import level_step_cuda
        w, i = level_step_cuda(masks, packed, terms, valid, vis,
                               v=v, k=k_eff, dedup=dedup)
        _count("level_step")
        _charge("level_step", masks, packed, terms, valid, vis, v=v, k=k_eff)
    else:
        w, i = ref.level_step_ref(masks, packed, terms, valid, vis,
                                  v=v, k=k_eff, dedup=dedup)
    if k_eff < k:
        pad = k - k_eff
        w = torch.nn.functional.pad(w, (0, pad), value=-1)
        i = torch.nn.functional.pad(i, (0, pad), value=0)
    return w, i


def _doc_axis_contiguous(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.int8:
        raise TypeError(f"{name} must be int8 0/1 incidence, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name} must be (D, V), got shape {tuple(x.shape)}")
    if x.shape[0] > 1 and x.stride(0) != 1:
        raise ValueError(
            f"{name} {tuple(x.shape)} has strides {x.stride()}: its doc axis "
            "(dim 0) must be contiguous — pass the .t() view of a term-major "
            "(V, D) tensor, as QueryContext.x_dense() is; cooccur_counts "
            "never copies its operands")


def cooccur_counts(x_l: torch.Tensor, x_r: torch.Tensor) -> torch.Tensor:
    """Integer co-occurrence counts ``C = x_l^T @ x_r`` as int32.

    x_l (D, Vl) and x_r (D, Vr): int8 0/1 incidence, each the ``.t()`` view
    of a term-major (V, D) tensor, so that the doc axis is contiguous ->
    (Vl, Vr) int32, exact at any D.  Mirrors
    ``repro.kernels.ops.cooccur_counts`` (whose operands are bf16).  Any
    shape: the kernel masks the ragged edges, so nothing is padded."""
    _doc_axis_contiguous(x_l, "x_l")
    _doc_axis_contiguous(x_r, "x_r")
    if x_l.shape[0] != x_r.shape[0]:
        raise ValueError(f"x_l has {x_l.shape[0]} docs, x_r {x_r.shape[0]}")
    if _is_meta(x_l):
        _charge("cooccur_counts", x_l, x_r)
        return torch.empty((x_l.shape[1], x_r.shape[1]), dtype=torch.int32,
                           device=x_l.device)
    if _on_cuda(x_l):
        from repro_torch.kernels.cooccur import cooccur_counts_cuda
        out, path = cooccur_counts_cuda(x_l.t(), x_r.t())
        if path is not None:
            _count("cooccur_counts", path)
            _charge("cooccur_counts", x_l, x_r)
        return out
    return ref.cooccur_counts_ref(x_l, x_r)


def row_top_k(counts: torch.Tensor, r0: int, k: int):
    """Each row's exact top-k of a row block's (R, V) int32 counts, row
    ``r`` being term ``r0 + r``, its self pair excluded: column ``min(r0 +
    r, V - 1)`` counts -1, below every zero count (a pad row past V hides
    column V - 1).  Values descending, lower column first on ties, as
    ``lax.top_k``; ``k > V`` clamps to V and pads the missing slots with
    weight -1 / id 0, as ``chunked_top_k`` does.  Returns (weights (R, k)
    int32, ids (R, k) int64).  Takes ``1 <= k <= ROW_TOPK_MAX_K`` on every
    device and raises for another k.  No reference kernel: the whole-
    network sweep's reduction of each row group's counts
    (``core.materialize._row_top_k``)."""
    if not 1 <= k <= ROW_TOPK_MAX_K:
        raise ValueError(f"row_top_k takes 1 <= k <= {ROW_TOPK_MAX_K}, "
                         f"got k={k}")
    if counts.dim() != 2:
        raise ValueError(f"counts must be (R, V), got shape "
                         f"{tuple(counts.shape)}")
    r, v = counts.shape
    k_eff = min(k, v)
    if _is_meta(counts):
        _charge("row_topk", counts, k=k_eff)
        return (torch.empty((r, k), dtype=torch.int32, device=counts.device),
                torch.empty((r, k), dtype=torch.int64, device=counts.device))
    if not _on_cuda(counts):
        return ref.row_top_k_ref(counts, r0, k)
    from repro_torch.kernels.row_topk import row_top_k_cuda
    w, i = row_top_k_cuda(counts, r0, k_eff)
    _count("row_topk")
    _charge("row_topk", counts, k=k_eff)
    if k_eff < k:
        w = torch.nn.functional.pad(w, (0, k - k_eff), value=-1)
        i = torch.nn.functional.pad(i, (0, k - k_eff), value=0)
    return w, i


def cooccur_counts_sharded(x_l: torch.Tensor, x_r: torch.Tensor, *,
                           mesh) -> torch.Tensor:
    """:func:`cooccur_counts` under a query mesh
    (:func:`repro_torch.core.distributed.make_cooc_mesh`): the kernel runs
    once per shard on that shard's operands, on its device, and the
    partials merge on the mesh's first device, bit for bit.  Mirrors
    ``repro.kernels.ops.cooccur_counts_sharded``.

    Term mesh ("model" axis): ``x_r``'s columns split into contiguous
    ranges and the (Vl, Vr/n) blocks concatenate.  Doc mesh ("data"
    axis): both operands' doc rows split (at multiples of 32 docs, so
    every shard's operands keep the kernel's 16-byte alignment) and the
    int32 partial products sum.  Nothing is padded or copied on the
    first device."""
    from repro_torch.core.distributed import (
        _placed,
        mesh_device,
        n_shards,
        shard_kind,
        shard_ranges,
    )
    n_data = mesh.shape.get("data", 1)
    n_model = mesh.shape.get("model", 1)
    if n_data > 1 and n_model > 1:
        raise ValueError("cooccur_counts_sharded shards one axis at a time; "
                         f"got mesh shape {dict(mesh.shape)}")
    n, dev0 = n_shards(mesh), mesh_device(mesh)
    devs = list(mesh.devices.flat)
    d, vr = x_r.shape
    if shard_kind(mesh) == "terms":
        return torch.cat([
            cooccur_counts(_placed(x_l, dev),
                           _placed(x_r[:, lo:hi], dev)).to(dev0)
            for dev, (lo, hi) in zip(devs, shard_ranges(vr, n)) if hi > lo],
            dim=1)
    out = None
    for dev, (lo, hi) in zip(devs, shard_ranges(d, n, 32)):
        if hi > lo:
            c = cooccur_counts(_placed(x_l[lo:hi], dev),
                               _placed(x_r[lo:hi], dev)).to(dev0)
            out = c if out is None else out + c
    if out is None:               # no docs: every count is zero
        out = torch.zeros((x_l.shape[1], vr), dtype=torch.int32,
                          device=dev0)
    return out


def cooccur_gemm(x_l: torch.Tensor, x_r: torch.Tensor) -> torch.Tensor:
    """``C = x_l^T @ x_r`` as float32: the counts of :func:`cooccur_counts`
    in the reference ``cooccur_gemm``'s output type."""
    return cooccur_counts(x_l, x_r).to(torch.float32)


def _dot_interaction_forward(x: torch.Tensor) -> torch.Tensor:
    if _is_meta(x):
        _charge("dot_interaction", x)
        f = x.shape[1]
        return x.new_empty((x.shape[0], f * (f - 1) // 2))
    if _on_cuda(x):
        from repro_torch.kernels.dot_interaction import dot_interaction_cuda
        out = dot_interaction_cuda(x)
        _count("dot_interaction")
        _charge("dot_interaction", x)
        return out
    return ref.dot_interaction_ref(x)


class DotInteraction(torch.autograd.Function):
    """Kernel 4 under autograd: the forward is :func:`dot_interaction`'s
    (the kernel on a CUDA tensor, its plain version on the CPU), the
    backward :func:`ref.dot_interaction_grad_ref` on either device.  The
    reference has no backward kernel (and its Pallas call no reverse-mode
    rule), so neither has the port."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _dot_interaction_forward(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return ref.dot_interaction_grad_ref(x, g)


def dot_interaction(x: torch.Tensor) -> torch.Tensor:
    """DLRM dot interaction: x (B, F, E) fp32 or bf16 -> (B, F (F - 1) / 2),
    the strict lower triangle of each sample's Gram matrix, row-major over
    i > j, summed in fp32, in x's dtype.  Mirrors
    ``repro.kernels.ops.dot_interaction``; any B, nothing padded.  Where
    autograd records x, the call goes through :class:`DotInteraction`;
    either way :data:`LAUNCHES` counts the forward launches only."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, F, E), got shape {tuple(x.shape)}")
    if x.requires_grad and torch.is_grad_enabled():
        return DotInteraction.apply(x)
    return _dot_interaction_forward(x)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, length,
                 *, chunk: int = 512) -> torch.Tensor:
    """GQA decode attention: q (B, Hq, d); k, v (B, S, Hkv, d), fp32 or
    bf16; ``length`` a scalar or (B,), the valid cache prefix of each row
    (clamped to [0, S]) -> (B, Hq, d) in q's dtype.  Mirrors
    ``repro.kernels.ops.flash_decode`` with the Pallas kernel's arithmetic
    (see :func:`repro_torch.kernels.ref.flash_decode_ref`); ``chunk`` sets
    only the padded S of the length-0 rule, as in the reference."""
    b, hq, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d \
            or v.shape != k.shape:
        raise ValueError(f"k, v must be (B, S, Hkv, d) matching q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    s, hkv = k.shape[1], k.shape[2]
    if s < 1 or hq % hkv:
        raise ValueError(f"S={s} must be >= 1 and Hq={hq} a multiple of "
                         f"Hkv={hkv}")
    if _is_meta(q):
        _charge("flash_decode", q, k, v)
        return torch.empty_like(q)
    if _on_cuda(q):
        from repro_torch.kernels.flash_decode import flash_decode_cuda
        ln = ref.decode_lengths(length, b, s, q.device)
        out = flash_decode_cuda(q, k, v, ln, chunk)
        _count("flash_decode")
        _charge("flash_decode", q, k, v)
        return out
    return ref.flash_decode_ref(q, k, v, length, chunk=chunk)


def decode_attn(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                length: torch.Tensor, k_cur: torch.Tensor,
                v_cur: torch.Tensor) -> torch.Tensor:
    """Decode attention over (cache prefix + current token), without writing
    the cache first.  Mirrors ``repro.kernels.ops.decode_attn``, which is
    plain XLA: this is plain PyTorch on every device, launches none of the
    hand-written kernels and counts nothing in :data:`LAUNCHES`.

    q (B, Hq, d); k_cache (B, S, Hkv, d), v_cache (B, S, Hkv, dv); length
    (B,) the valid cache entries of each row (the current token is in
    addition to these); k_cur (B, Hkv, d), v_cur (B, Hkv, dv).  The current
    token's scores merge with the cache's through an explicit max and
    sum of exponentials.  Scores and sums are fp32 (products of the
    operands in their promoted dtype, accumulated in fp32); the cache's
    weights are cast once to v_cache's dtype.  Returns (B, Hq, dv) in q's
    dtype.
    """
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    g = hq // hkv
    f32 = torch.float32
    qg = q.reshape(b, hkv, g, d).to(f32)
    # the reference's fp32 1 / sqrt(d), computed on the host: a scalar
    # sent to the card would stall its queue
    scale = torch.tensor(d, dtype=f32).sqrt().reciprocal().item()
    s1 = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.to(f32)) * scale
    pos = torch.arange(s, device=q.device)
    ln = torch.broadcast_to(torch.as_tensor(length, device=q.device), (b,))
    s1 = torch.where((pos[None, :] < ln[:, None])[:, None, None, :], s1,
                     -1e30)
    s2 = torch.einsum("bhgd,bhd->bhg", qg, k_cur.to(f32)) * scale
    m = torch.maximum(torch.amax(s1, dim=-1), s2)                # (B,H,G)
    e1 = torch.exp(s1 - m[..., None])
    e2 = torch.exp(s2 - m)
    denom = torch.sum(e1, dim=-1) + e2
    o1 = torch.einsum("bhgs,bshd->bhgd", e1.to(v_cache.dtype).to(f32),
                      v_cache.to(f32))
    out = (o1 + e2[..., None] * v_cur.to(f32)[:, :, None, :]) \
        / denom[..., None]
    return out.reshape(b, hq, dv).to(q.dtype)
