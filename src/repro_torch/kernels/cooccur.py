"""Launcher of the hand-written CUDA co-occurrence kernel
(``csrc/cooccur.cu``).

Replaces ``repro/kernels/cooccur.py::cooccur_gemm_pallas``: integer
co-occurrence counts of 0/1 incidence operands on the int8 tensor cores.
Operands that TMA can describe (16-byte aligned bases and row strides:
every operand of the main path) take the ``wgmma`` kernel fed by TMA;
others take an ``mma.sync`` kernel with byte loads.  Its plain version is
:func:`repro_torch.kernels.ref.cooccur_counts_ref`; callers go through
:func:`repro_torch.kernels.ops.cooccur_counts`, which picks one by the
tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_MAX_COL_TILES = 65535   # grid.y limit; 128 columns per tile of the fallback
#: what the C entry point reports it launched
PATHS = {1: "tma", 2: "bytes"}


def _entry():
    fn = build.library("cooccur").cooccur_counts_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def cooccur_counts_cuda(a: torch.Tensor, b: torch.Tensor):
    """C[m, n] = sum_k a[m, k] * b[n, k] as int32.

    a (M, K) and b (N, K) int8 on one CUDA device, each with K contiguous
    (``stride(1) == 1``; any row stride).  Neither operand is copied or
    padded: the kernel masks the ragged edges itself.  Returns (C, path),
    path ``"tma"`` (the ``wgmma`` kernel) or ``"bytes"`` (the fallback),
    as the launch reports it; ``None`` if nothing launched (M, N or K is
    0)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"cooccur kernel takes int8 0/1 operands, got "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device or not a.is_cuda:
        raise ValueError(f"cooccur kernel needs both operands on one CUDA "
                         f"device, got {a.device} and {b.device}")
    m, k = a.shape
    n, k2 = b.shape
    if k != k2:
        raise ValueError(f"operands have {k} and {k2} docs")
    for name, x in (("a", a), ("b", b)):
        if x.shape[1] > 1 and x.stride(1) != 1:
            raise ValueError(f"cooccur kernel operand {name} must have its "
                             f"doc axis contiguous, got strides {x.stride()}")
    if (n + 127) // 128 > _MAX_COL_TILES:
        raise ValueError(f"N={n} exceeds the kernel's column grid")
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    path = ctypes.c_int(0)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _entry()(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                      a.stride(0), b.stride(0), ctypes.byref(path), stream)
    build.check(rc, "cooccur_counts")
    return out, PATHS.get(path.value)
