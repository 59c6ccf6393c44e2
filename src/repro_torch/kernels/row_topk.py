"""Launcher of the hand-written CUDA per-row top-k (``csrc/row_topk.cu``).

Replaces no TPU kernel: the whole-network sweep's reduction of a row
group's (rows, V) int32 counts to each row's exact top-k, self pair
excluded, which the port took with ``torch.topk`` over int64 keys built
from a copy of the counts.  One launch reads each count once.  Its plain
version is :func:`repro_torch.kernels.ref.row_top_k_ref`; callers go
through :func:`repro_torch.kernels.ops.row_top_k`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: the largest k the kernel takes (csrc kMaxK)
MAX_K = 128


def _entry():
    fn = build.library("row_topk").row_topk_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def row_top_k_cuda(counts: torch.Tensor, r0: int, k: int):
    """Same contract as :func:`repro_torch.kernels.ref.row_top_k_ref` for
    ``1 <= k <= min(V, MAX_K)``, on a CUDA tensor: counts (R, V) int32
    with its columns contiguous (any row stride of at least V), read in
    place.  Returns (weights (R, k) int32, ids (R, k) int64)."""
    if not counts.is_cuda or counts.dtype != torch.int32 or counts.dim() != 2:
        raise TypeError(f"row top-k kernel takes (R, V) int32 counts on a "
                        f"CUDA device, got {counts.dtype} "
                        f"{tuple(counts.shape)} on {counts.device}")
    r, v = counts.shape
    if not 1 <= k <= min(v, MAX_K):
        raise ValueError(f"row top-k kernel takes 1 <= k <= min(V, {MAX_K})"
                         f", got k={k} over V={v}")
    if (v > 1 and counts.stride(1) != 1) or (r > 1 and counts.stride(0) < v):
        raise ValueError(f"row top-k kernel reads rows of contiguous "
                         f"columns, got strides {counts.stride()} for "
                         f"{tuple(counts.shape)}")
    ld = counts.stride(0) if r > 1 else v
    w_out = torch.empty((r, k), dtype=torch.int32, device=counts.device)
    i_out = torch.empty((r, k), dtype=torch.int64, device=counts.device)
    with torch.cuda.device(counts.device):
        stream = torch.cuda.current_stream(counts.device).cuda_stream
        rc = _entry()(counts.data_ptr(), ld, r, v, int(r0), k,
                      w_out.data_ptr(), i_out.data_ptr(), stream)
    build.check(rc, "row_top_k")
    return w_out, i_out
