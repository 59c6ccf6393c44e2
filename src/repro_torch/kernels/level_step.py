"""Launcher of the hand-written CUDA fused level step (``csrc/level_step.cu``).

Replaces ``repro/kernels/level_step.py::level_step_pallas``: one BFS level's
AND + popcount counts over the padded transposed postings, the masking
rules, and an exact top-k in ``lax.top_k`` order, in two launches (per-tile
top-k, then a per-row merge) whose scratch this wrapper allocates.  Its plain
version is :func:`repro_torch.kernels.ref.level_step_ref`; callers go
through :func:`repro_torch.kernels.ops.level_step`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

TILE_V = 128     # columns per CTA of the tile stage (csrc kTileV)
_MAX_TILES = 65535


def _entry():
    fn = build.library("level_step").level_step_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def level_step_cuda(masks: torch.Tensor, packed_t_pad: torch.Tensor,
                    terms: torch.Tensor, valid: torch.Tensor,
                    visited: torch.Tensor, *, v: int, k: int, dedup: bool):
    """Same contract as :func:`repro_torch.kernels.ref.level_step_ref`, on
    CUDA tensors: masks (R, Wm) int32, packed_t_pad (V_pad, W_pad) int32,
    terms (R,), valid (R,), visited (Q, v); ``1 <= k <= v``.  Returns
    (weights, ids), both (R, k) int32."""
    dev = masks.device
    if not masks.is_cuda or any(t.device != dev for t in
                                (packed_t_pad, terms, valid, visited)):
        raise ValueError("level step kernel needs every operand on one CUDA "
                         "device")
    if masks.dtype != torch.int32 or packed_t_pad.dtype != torch.int32:
        raise TypeError(f"level step kernel takes int32 bit patterns, got "
                        f"{masks.dtype} and {packed_t_pad.dtype}")
    r, wm = masks.shape
    vp, wp = packed_t_pad.shape
    q = visited.shape[0]
    if not 1 <= k <= v <= vp or wm > wp or r % q or visited.shape[1] != v:
        raise ValueError(f"bad level step shapes: masks {tuple(masks.shape)}, "
                         f"packed_t_pad {(vp, wp)}, visited "
                         f"{tuple(visited.shape)}, v={v}, k={k}")
    n_tiles = (vp + TILE_V - 1) // TILE_V
    if n_tiles > _MAX_TILES:
        raise ValueError(f"V_pad={vp} exceeds the kernel's column grid")
    kt = min(k, TILE_V)
    masks = masks.contiguous()
    packed_t_pad = packed_t_pad.contiguous()
    terms = terms.to(torch.int32).contiguous()
    valid = valid.to(torch.int32).contiguous()
    vis = visited.to(torch.int32).contiguous() if dedup else None
    scratch = torch.empty((r, n_tiles, kt), dtype=torch.int64, device=dev)
    w_out = torch.empty((r, k), dtype=torch.int32, device=dev)
    i_out = torch.empty((r, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(masks.data_ptr(), packed_t_pad.data_ptr(),
                      terms.data_ptr(), valid.data_ptr(),
                      vis.data_ptr() if vis is not None else None,
                      scratch.data_ptr(), w_out.data_ptr(), i_out.data_ptr(),
                      r, wm, wp, vp, v, k, max(r // q, 1), int(dedup), stream)
    build.check(rc, "level_step")
    return w_out, i_out
