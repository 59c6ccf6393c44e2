"""Launcher of the hand-written CUDA fused level step (``csrc/level_step.cu``).

Replaces ``repro/kernels/level_step.py::level_step_pallas``: one BFS level's
AND + popcount counts over the postings, the masking rules, and an exact
top-k in ``lax.top_k`` order.  Three launches: the postings kernel's
compaction (:func:`repro_torch.kernels.postings.active_words_cuda`: each
4-row tile's nonzero mask words), then per-tile counts over those words
only with the masks and a per-tile top-k, then a per-row merge; this
wrapper allocates their scratch.  Its plain version is
:func:`repro_torch.kernels.ref.level_step_ref`; callers go through
:func:`repro_torch.kernels.ops.level_step`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, postings

TILE_V = 256     # columns per CTA of the tile stage (csrc kThreads)
_MAX_TILES = 65535


def _entry():
    fn = build.library("level_step").level_step_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def level_step_cuda(masks: torch.Tensor, packed: torch.Tensor,
                    terms: torch.Tensor, valid: torch.Tensor,
                    visited: torch.Tensor, *, v: int, k: int, dedup: bool):
    """Same contract as :func:`repro_torch.kernels.ref.level_step_ref`, on
    CUDA tensors: masks (R, W) int32, packed (W, V) int32 with V >= v (the
    index's postings), terms (R,), valid (R,), visited (Q, v);
    ``1 <= k <= v``.  Returns (weights, ids), both (R, k) int32."""
    dev = masks.device
    if not masks.is_cuda or any(t.device != dev for t in
                                (packed, terms, valid, visited)):
        raise ValueError("level step kernel needs every operand on one CUDA "
                         "device")
    if masks.dtype != torch.int32 or packed.dtype != torch.int32:
        raise TypeError(f"level step kernel takes int32 bit patterns, got "
                        f"{masks.dtype} and {packed.dtype}")
    r, w = masks.shape
    w2, vp = packed.shape
    q = visited.shape[0]
    if not 1 <= k <= v <= vp or w != w2 or r % q or visited.shape[1] != v:
        raise ValueError(f"bad level step shapes: masks {tuple(masks.shape)}, "
                         f"packed {(w2, vp)}, visited "
                         f"{tuple(visited.shape)}, v={v}, k={k}")
    n_tiles = (vp + TILE_V - 1) // TILE_V
    if n_tiles > _MAX_TILES:
        raise ValueError(f"V={vp} exceeds the kernel's column grid")
    kt = min(k, TILE_V)
    packed = packed.contiguous()
    terms = terms.to(torch.int32).contiguous()
    valid = valid.to(torch.int32).contiguous()
    vis = visited.to(torch.int32).contiguous() if dedup else None
    words, n, staged = postings.active_words_cuda(masks)
    scratch = torch.empty((r, n_tiles, kt), dtype=torch.int64, device=dev)
    w_out = torch.empty((r, k), dtype=torch.int32, device=dev)
    i_out = torch.empty((r, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(staged.data_ptr(), words.data_ptr(), n.data_ptr(),
                      packed.data_ptr(), terms.data_ptr(), valid.data_ptr(),
                      vis.data_ptr() if vis is not None else None,
                      scratch.data_ptr(), w_out.data_ptr(), i_out.data_ptr(),
                      r, w, vp, v, k, max(r // q, 1), int(dedup), stream)
    build.check(rc, "level_step")
    return w_out, i_out
