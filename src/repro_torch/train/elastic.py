"""Elastic mesh management: device failure -> shrink the mesh -> reshard
the state.  ``MeshPlan``, ``plan_mesh`` and ``simulate_failure`` are
copies of ``repro.train.elastic``'s (host-only code).

The recovery contract:

  1. the runtime detects a failed host (here: simulated by removing
     devices from the device list);
  2. ``plan_mesh`` recomputes the largest valid (data, model) [or (pod,
     data, model)] mesh from the surviving device count, keeping the model
     axis fixed when possible (TP degree is baked into weight shapes;
     shrinking it is a reshard, shrinking data parallelism is free);
  3. the state restores from the latest checkpoint;
  4. the data pipeline's (seed, step) contract resumes the stream.

``build_mesh`` lays a plan out as a
:class:`repro_torch.launch.mesh.DeviceMesh` (re-exported here), a grid
of torch devices driven by one process, as
:class:`repro_torch.core.distributed.CoocMesh` is: there is no
``torch.distributed`` process group, and a device may repeat (four
shards of one card).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.launch.mesh import DeviceMesh, make_mesh  # noqa: F401


@dataclasses.dataclass
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))


def plan_mesh(n_devices: int, *, model_parallel: int = 16,
              multi_pod: bool = False, pods: int = 2) -> MeshPlan:
    """Largest mesh using <= n_devices, preferring to keep TP fixed.

    Degrades TP only when fewer than one TP group survives.
    """
    if multi_pod and n_devices >= pods * model_parallel:
        per_pod = n_devices // pods
        data = per_pod // model_parallel
        if data >= 1:
            return MeshPlan((pods, data, model_parallel), ("pod", "data", "model"))
    mp = model_parallel
    while mp > 1 and n_devices < mp:
        mp //= 2
    data = max(n_devices // mp, 1)
    return MeshPlan((data, mp), ("data", "model"))


def build_mesh(plan: MeshPlan, devices: Optional[Sequence] = None
               ) -> DeviceMesh:
    """The plan's grid over ``devices`` (default: every card)."""
    return make_mesh(plan.shape, plan.axes, devices)


def simulate_failure(n_devices: int, n_failed: int, *, model_parallel: int = 16,
                     multi_pod: bool = False) -> Tuple[MeshPlan, MeshPlan]:
    """(before, after) mesh plans for a failure of n_failed devices."""
    before = plan_mesh(n_devices, model_parallel=model_parallel, multi_pod=multi_pod)
    after = plan_mesh(n_devices - n_failed, model_parallel=model_parallel,
                      multi_pod=multi_pod)
    return before, after
