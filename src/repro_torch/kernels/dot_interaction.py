"""Launcher of the hand-written CUDA dot-interaction kernel
(``csrc/dot_interaction.cu``).

Replaces ``repro/kernels/dot_interaction.py::dot_interaction_pallas``: the
strict lower triangle of each sample's Gram matrix, the interaction of
DLRM.  Its plain version is
:func:`repro_torch.kernels.ref.dot_interaction_ref`; callers go through
:func:`repro_torch.kernels.ops.dot_interaction`, which picks one by the
tensor's device.

The launch plan is computed here (:func:`launch_plan`), so that the CPU
tests can check it: B is cut into groups of consecutive samples, as even
as can be.  Up to ``MAX_WARPS`` samples a SM there is one group, and one
CTA, a SM; beyond that groups of ``MAX_WARPS`` samples, and past the CTAs
that fit on the card at once a persistent grid walks them through a ring
of bulk copies.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build

#: input types the kernel takes, by its dtype code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_F, MAX_E = 64, 256
MAX_WARPS = 4             # consumer warps a CTA, one sample each at F = 27
STAGES = 2                # ring depth of the bulk path
SMEM_MAX = 232_448        # dynamic shared memory a CTA may take (sm_90)
SMEM_PER_SM = 233_472     # shared memory an SM holds, 1 KB of it per CTA
                          # reserved by the runtime
THREADS_PER_SM = 2048


@dataclasses.dataclass(frozen=True)
class Layout:
    """Shared-memory layout of one sample (mirrors ``make_shape`` in the
    CUDA source): 4-row blocks with 16 bytes of skew each, a sample pitch
    of an odd number of 16-byte words."""
    pairs: int            # F (F - 1) / 2
    tiles: int            # 4 x 4 tiles of the triangle, diagonal included
    lanes: int            # lanes a sample: a power of 2, at most 32
    row_bytes: int        # a row padded to whole 16-byte words
    sample_bytes: int

    @property
    def per_warp(self) -> int:
        """Samples a warp takes at once."""
        return 32 // self.lanes


@dataclasses.dataclass(frozen=True)
class Plan:
    groups: int           # B // groups samples each, one more in the first
                          # B % groups
    samples: int          # samples a group at most (its shared memory)
    warps: int            # consumer warps a CTA
    stages: int           # ring stages (1 on the plain path)
    grid: int             # CTAs; each walks groups blockIdx, + grid, ...
    bulk: bool            # bulk copies (else the plain load path)
    smem: int             # dynamic shared memory a CTA, bytes

    @property
    def threads(self) -> int:
        return 32 * (self.warps + self.bulk)


def layout(f: int, e: int, itemsize: int) -> Layout:
    nb = (f + 3) // 4
    tiles = nb * (nb + 1) // 2
    lanes = 1
    while lanes < min(tiles, 32):
        lanes *= 2
    row = -(-e * itemsize // 16) * 16
    sample = nb * (4 * row + 16)
    if (sample // 16) % 2 == 0:
        sample += 16
    return Layout(f * (f - 1) // 2, tiles, lanes, row, sample)


def smem_bytes(lay: Layout, samples: int, stages: int) -> int:
    """Shared memory of a CTA: the ring, the samples' fp32 triangles, and
    two mbarriers a stage."""
    out_end = stages * samples * lay.sample_bytes + samples * lay.pairs * 4
    return -(-out_end // 16) * 16 + 16 * stages


def bulk_ok(ptr: int, e: int, itemsize: int) -> bool:
    """Whether the bulk copies can fetch x: a 16-byte aligned base and rows
    of whole 16-byte words (each 4-row block is then 16-byte aligned)."""
    return ptr % 16 == 0 and (e * itemsize) % 16 == 0


@functools.lru_cache(maxsize=1024)
def launch_plan(b: int, f: int, e: int, itemsize: int, bulk: bool,
                sms: int) -> Plan:
    """The plan of one launch over ``b`` samples of (f, e) on a card with
    ``sms`` SMs.  A warp takes one sample (several at small F); a CTA at
    most ``MAX_WARPS`` warps, fewer where shared memory runs out.  While
    that covers B with one CTA a SM, there are min(SMs, B) groups of
    B // groups samples, one more in the first B % groups: one wave, at
    most one sample a warp scheduler.  Beyond, groups of the CTA's full size, as many CTAs
    as fit on the SMs at once, and a ring as deep as the groups each CTA
    walks (at most ``STAGES``)."""
    lay = layout(f, e, itemsize)
    spw = lay.per_warp
    stages = STAGES if bulk else 1
    warps = MAX_WARPS
    while warps > 1 and smem_bytes(lay, warps * spw, stages) > SMEM_MAX:
        warps -= 1
    while smem_bytes(lay, warps * spw, stages) > SMEM_MAX:
        stages -= 1
    if b <= warps * spw * sms:                        # one wave
        groups = min(sms, -(-b // spw))
        largest = -(-b // groups)
        warps = -(-largest // spw)
        grid, stages = groups, 1
    else:
        groups = -(-b // (warps * spw))
        per_sm = min(SMEM_PER_SM // (smem_bytes(lay, warps * spw, stages)
                                     + 1024),
                     THREADS_PER_SM // (32 * (warps + bulk)))
        grid = min(groups, sms * max(1, per_sm))
        stages = min(stages, -(-groups // grid))
    samples = warps * spw
    return Plan(groups, samples, warps, stages, grid, bulk,
                smem_bytes(lay, samples, stages))


class _CPlan(ctypes.Structure):
    """A plan as the C entry point takes it (``struct Plan``)."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "b", "f", "e", "dtype", "samples", "warps", "stages", "grid",
        "groups", "bulk")]


@functools.lru_cache(maxsize=1024)
def _c_plan(b: int, f: int, e: int, dtype: torch.dtype, bulk: bool,
            sms: int) -> _CPlan:
    p = launch_plan(b, f, e, dtype.itemsize, bulk, sms)
    return _CPlan(b, f, e, DTYPES[dtype], p.samples, p.warps, p.stages,
                  p.grid, p.groups, int(p.bulk))


_SMS = {}


def _sms(index: int) -> int:
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.library("dot_interaction").dot_interaction_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_CPlan),
                   ctypes.c_int, ctypes.c_void_p]
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
    # the host path is kept lean for serve_p99's few-microsecond kernel:
    # the plan and its C struct are cached by shape, the C entry point makes
    # x's device current only if it is not, and the stream is read as its
    # raw handle (torch.cuda.current_stream() builds a Stream object)
    out = x.new_empty((b, f * (f - 1) // 2))
    ptr, index = x.data_ptr(), x.get_device()
    plan = _c_plan(b, f, e, x.dtype, bulk_ok(ptr, e, x.element_size()),
                   _sms(index))
    rc = _entry()(ptr, out.data_ptr(), plan, index,
                  torch._C._cuda_getCurrentRawStream(index))
    build.check(rc, "dot_interaction")
    return out
