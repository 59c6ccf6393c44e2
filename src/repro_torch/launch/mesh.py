"""Meshes: named grids of torch devices, driven by one process.

Functions, not module-level constants, so importing this module touches
no device.

Single-pod: (16, 16)    axes ("data", "model")        = 256 chips
Multi-pod:  (2, 16, 16) axes ("pod", "data", "model") = 512 chips

The production meshes are the reference's shapes laid over PyTorch's
``meta`` device, its placeholder that allocates nothing: what the
reference's dry-run gets from 512 forced host devices.  The grid holds
one ``meta`` device per chip; a device may repeat in any grid (four
shards of one card), as in :class:`repro_torch.core.distributed.CoocMesh`.
There is no ``torch.distributed`` process group.

The hardware constants keep the reference's names and hold the NVIDIA
H100 SXM data sheet's values at 700 W.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import canonical_device, resolve_device

# Hardware constants (H100 SXM data sheet, 700 W): per-chip roofline terms
PEAK_FLOPS_BF16 = 989e12     # FLOP/s per chip, dense bf16 tensor cores
HBM_BW = 3.35e12             # bytes/s per chip, HBM3
ICI_BW = 450e9               # bytes/s per chip and direction, NVLink 4
# the rates of the other units the hand-written kernels run on
PEAK_OPS_INT8 = 1979e12      # op/s per chip, dense int8 tensor cores
PEAK_FLOPS_FP32 = 67e12      # FLOP/s per chip, fp32 outside the tensor cores
# 32-bit popcounts/s: 132 SMs x 16 a clock (CUDA programming guide,
# compute capability 9.0) x the 1.98 GHz boost clock
PEAK_POPC = 132 * 16 * 1.98e9


class DeviceMesh:
    """A grid of torch devices with named axes, driven by one process."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.empty(np.shape(devices), dtype=object)
        src = np.asarray(devices, dtype=object)
        for pos in np.ndindex(grid.shape):
            grid[pos] = canonical_device(src[pos])
        if grid.ndim != len(tuple(axis_names)):
            raise ValueError(f"a {grid.ndim}-D grid needs {grid.ndim} axis "
                             f"names, got {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _cards():
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape, axes, devices: Optional[Sequence] = None) -> DeviceMesh:
    """The first ``prod(shape)`` of ``devices`` (default: every card) as a
    grid of ``shape`` with ``axes`` names."""
    devs = list(_cards() if devices is None else devices)
    need = int(np.prod(shape))
    if len(devs) < need:
        raise ValueError(f"a {tuple(shape)} mesh needs {need} devices, got "
                         f"{len(devs)}")
    arr = np.empty(need, dtype=object)
    arr[:] = devs[:need]
    return DeviceMesh(arr.reshape(tuple(shape)), axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's production mesh over ``meta`` placeholder devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, [torch.device("meta")] * int(np.prod(shape)))


def make_host_mesh(device=None) -> DeviceMesh:
    """The devices present as an (n, 1) ("data", "model") mesh: every card
    (``device`` None or ``"cuda"``), or the one device named (``"cpu"``,
    ``"cuda:1"``, ``"meta"``).  Without a card and without ``device`` it
    raises, as every entry point does."""
    if device is None or torch.device(device) == torch.device("cuda"):
        devs = _cards()
    else:
        devs = [resolve_device(device)]
    return make_mesh((len(devs), 1), ("data", "model"), devs)
