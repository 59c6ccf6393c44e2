"""Launcher of the hand-written CUDA postings kernel (``csrc/postings.cu``).

Replaces ``repro/kernels/postings.py::postings_counts_pallas``:
``counts[b, v] = sum_w popcount(masks[b, w] & packed[w, v])``.  Its plain
version is :func:`repro_torch.kernels.ref.postings_counts_ref`; callers go
through :func:`repro_torch.kernels.ops.postings_counts`, which picks one by
the tensor's device.

The kernel is two launches: :func:`active_words_cuda` lists, for each tile
of :data:`ROWS` mask rows, the words at which any row is nonzero (its plain
version is :func:`repro_torch.kernels.ref.active_words_ref`), and the count
launch walks only those words.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_MAX_COL_TILES = 65535   # grid.y limit; 256 columns per tile
#: mask rows a tile, ``kRows`` of ``csrc/postings.cu``: of 4, 8 and 16
#: rows, 4 took least time at the CSL level-1 frontier on an H100
#: (PERF.md)
ROWS = 4


def _lib():
    lib = build.library("postings")
    if lib.postings_compact_launch.argtypes is None:
        lib.postings_compact_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.postings_compact_launch.restype = ctypes.c_int
        lib.postings_counts_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.postings_counts_launch.restype = ctypes.c_int
    return lib


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def active_words_cuda(masks: torch.Tensor):
    """The compaction launch: masks (B, W) int32 bit patterns on a CUDA
    device -> (words (T, W) int32, n (T,) int32, staged (T, W, ROWS)
    int32), T = ceil(B / ROWS).  ``words[t, :n[t]]`` are, ascending, the
    words at which any row of tile t is nonzero, and ``staged[t, j, r]``
    is ``masks[t * ROWS + r, words[t, j]]`` (0 past B); the rest of
    ``words`` and ``staged`` is left unwritten."""
    if masks.dtype != torch.int32 or not masks.is_cuda:
        raise ValueError(f"compaction takes int32 masks on a CUDA device, "
                         f"got {masks.dtype} on {masks.device}")
    masks = masks.contiguous()
    b, w = masks.shape
    t = -(-b // ROWS)
    words = torch.empty((t, w), dtype=torch.int32, device=masks.device)
    n = torch.empty((t,), dtype=torch.int32, device=masks.device)
    staged = torch.empty((t, w, ROWS), dtype=torch.int32, device=masks.device)
    with torch.cuda.device(masks.device):
        rc = _lib().postings_compact_launch(
            masks.data_ptr(), words.data_ptr(), n.data_ptr(),
            staged.data_ptr(), b, w, _stream(masks))
    build.check(rc, "postings_compact")
    return words, n, staged


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
    packed = packed.contiguous()
    words, n, staged = active_words_cuda(masks)
    out = torch.empty((b, v), dtype=torch.int32, device=masks.device)
    with torch.cuda.device(masks.device):
        rc = _lib().postings_counts_launch(
            staged.data_ptr(), words.data_ptr(), n.data_ptr(),
            packed.data_ptr(), out.data_ptr(), b, w, v, _stream(masks))
    build.check(rc, "postings_counts")
    return out
