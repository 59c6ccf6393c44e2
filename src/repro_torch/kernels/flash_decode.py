"""Launcher of the hand-written CUDA flash-decode kernel
(``csrc/flash_decode.cu``).

Replaces ``repro/kernels/flash_decode.py::flash_decode_pallas``: GQA decode
attention over a long KV cache with an online softmax, ragged lengths and
fp32 statistics.  Its plain version is
:func:`repro_torch.kernels.ref.flash_decode_ref`; callers go through
:func:`repro_torch.kernels.ops.flash_decode`, which picks one by the
tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_G, MAX_D = 16, 256
TILE = 64                 # KV rows per tile in the kernel (32 for fp32 at
                          # d > 128, which divides it)
CTAS_PER_SM = 2           # launch 1 at bf16, d = 128: 110 KB of smem each
WAVES = 16                # aim for this many full waves of launch 1 ...
MIN_TILES = 64            # ... with at least this many tiles a CTA


def _entry():
    fn = build.library("flash_decode").flash_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def split_plan(b: int, hkv: int, s: int, sms: int):
    """(split_len, n_split): S cut into ranges of whole 64-row tiles so
    that B x Hkv x n_split CTAs fill the SMs, CTAS_PER_SM at a time, about
    WAVES times over, unless that leaves a CTA fewer than MIN_TILES tiles
    (each split is one more partial for launch 2 to merge).
    ``split_len * n_split >= s`` and every split holds at least one row of
    S."""
    tiles = -(-s // TILE)
    want = max(1, -(-WAVES * CTAS_PER_SM * sms // (b * hkv)))
    per = max(-(-tiles // min(tiles, want)), min(tiles, MIN_TILES))
    split_len = per * TILE
    return split_len, -(-s // split_len)


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      length: torch.Tensor, chunk: int) -> torch.Tensor:
    """q (B, Hq, d); k, v (B, S, Hkv, d), contiguous, one dtype (fp32 or
    bf16), on one CUDA device; ``length`` (B,) int32 in [0, S]; ``chunk``
    sets the padded S of the length-0 rule
    (:func:`repro_torch.kernels.ref.decode_pad`).  Returns (B, Hq, d) in
    q's dtype."""
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode kernel takes fp32 or bf16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and length.device == q.device):
        raise ValueError("flash_decode kernel needs q, k, v and length on one "
                         "CUDA device")
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    g = hq // hkv
    if not (1 <= g <= MAX_G and d % 8 == 0 and 8 <= d <= MAX_D):
        raise ValueError(f"flash_decode kernel takes G = Hq / Hkv <= {MAX_G} "
                         f"and d a multiple of 8 up to {MAX_D}, got G={g}, "
                         f"d={d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_decode kernel takes a contiguous, "
                             f"16-byte aligned {name}")
    if b > 65535 or hkv > 65535:
        raise ValueError(f"B={b} or Hkv={hkv} is beyond the kernel's grid")
    if length.dtype != torch.int32 or length.shape != (b,):
        raise ValueError(f"length must be ({b},) int32, got "
                         f"{tuple(length.shape)} {length.dtype}")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    split_len, n_split = split_plan(b, hkv, s, sms)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty((b, hkv, n_split, g), **f32)
    part_l = torch.empty((b, hkv, n_split, g), **f32)
    part_acc = torch.empty((b, hkv, n_split, g, d), **f32)
    out = torch.empty_like(q)
    pad = ref.decode_pad(s, chunk) - s
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      length.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
                      part_acc.data_ptr(), out.data_ptr(), b, s, hkv, g, d,
                      split_len, n_split, pad, DTYPES[q.dtype], stream)
    build.check(rc, "flash_decode")
    return out
