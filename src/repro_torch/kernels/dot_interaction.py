"""Launcher of the hand-written CUDA dot-interaction kernel
(``csrc/dot_interaction.cu``).

Replaces ``repro/kernels/dot_interaction.py::dot_interaction_pallas``: the
strict lower triangle of each sample's Gram matrix, the interaction of
DLRM.  Its plain version is
:func:`repro_torch.kernels.ref.dot_interaction_ref`; callers go through
:func:`repro_torch.kernels.ops.dot_interaction`, which picks one by the
tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: input types the kernel takes, by its dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_F, MAX_E = 64, 256


def _entry():
    fn = build.library("dot_interaction").dot_interaction_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def dot_interaction_cuda(x: torch.Tensor) -> torch.Tensor:
    """x (B, F, E) fp32 or bf16, contiguous, on a CUDA device ->
    (B, F (F - 1) / 2) in x's dtype, sums in fp32.  Any B; 2 <= F <= 64,
    E <= 256."""
    if x.dtype not in DTYPES:
        raise TypeError(f"dot_interaction kernel takes fp32 or bf16, got "
                        f"{x.dtype}")
    if x.dim() != 3 or not x.is_cuda:
        raise ValueError(f"dot_interaction kernel takes (B, F, E) on a CUDA "
                         f"device, got {tuple(x.shape)} on {x.device}")
    b, f, e = x.shape
    if not (2 <= f <= MAX_F and 1 <= e <= MAX_E):
        raise ValueError(f"dot_interaction kernel takes 2 <= F <= {MAX_F} and "
                         f"E <= {MAX_E}, got F={f}, E={e}")
    if not x.is_contiguous():
        raise ValueError("dot_interaction kernel takes a contiguous x; the "
                         "DLRM path builds it in one preallocated tensor")
    if b >= 1 << 31:
        raise ValueError(f"B={b} is beyond the kernel's int32 batch")
    out = torch.empty((b, f * (f - 1) // 2), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _entry()(x.data_ptr(), out.data_ptr(), b, f, e, DTYPES[x.dtype],
                      stream)
    build.check(rc, "dot_interaction")
    return out
