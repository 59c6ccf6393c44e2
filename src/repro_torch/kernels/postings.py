"""Launcher of the hand-written CUDA postings kernel (``csrc/postings.cu``).

Replaces ``repro/kernels/postings.py::postings_counts_pallas``:
``counts[b, v] = sum_w popcount(masks[b, w] & packed[w, v])``.  Its plain
version is :func:`repro_torch.kernels.ref.postings_counts_ref`; callers go
through :func:`repro_torch.kernels.ops.postings_counts`, which picks one by
the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_MAX_COL_TILES = 65535   # grid.y limit; 256 columns per tile


def _entry():
    fn = build.library("postings").postings_counts_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def postings_counts_cuda(masks: torch.Tensor,
                         packed: torch.Tensor) -> torch.Tensor:
    """masks (B, W), packed (W, V) int32 bit patterns on one CUDA device ->
    counts (B, V) int32.  Any B, W, V: the kernel masks the ragged edges."""
    if masks.dtype != torch.int32 or packed.dtype != torch.int32:
        raise TypeError(f"postings kernel takes int32 bit patterns, got "
                        f"{masks.dtype} and {packed.dtype}")
    if masks.device != packed.device or not masks.is_cuda:
        raise ValueError(f"postings kernel needs both operands on one CUDA "
                         f"device, got {masks.device} and {packed.device}")
    b, w = masks.shape
    w2, v = packed.shape
    if w != w2:
        raise ValueError(f"masks have {w} words, packed has {w2}")
    if (v + 255) // 256 > _MAX_COL_TILES:
        raise ValueError(f"V={v} exceeds the kernel's column grid")
    masks = masks.contiguous()
    packed = packed.contiguous()
    out = torch.empty((b, v), dtype=torch.int32, device=masks.device)
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream(masks.device).cuda_stream
        rc = _entry()(masks.data_ptr(), packed.data_ptr(), out.data_ptr(),
                      b, w, v, stream)
    build.check(rc, "postings_counts")
    return out
