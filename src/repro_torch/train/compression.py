"""Gradient compression: int8 all-reduce with error feedback, the
protocol of ``repro.train.compression``.

Per tensor, over the data shards:
  1. e   = grad + residual
  2. s   = max over shards of max|e| / 127   (shared scale, one scalar)
  3. q   = round(e / s) in int8              (payload: 1 byte/elem)
  4. g'  = (sum over shards of q, in int32) * s / n_shards
  5. residual = e - q * s

The reference runs this inside ``shard_map``, one program per device.  The
port drives the shards from one process, as its query mesh does
(:class:`repro_torch.core.distributed.CoocMesh`): :func:`compressed_psum`
takes one tree per shard, each on its shard's device (a device may
repeat), reduces on the first shard's device (the max, then the int32
sum in shard order) and hands every shard the same mean.  Each shard
keeps its own residual, as each device keeps its own buffer under the
reference's ``shard_map``.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.train.step import loss_and_grads


def quantize_int8(e: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(e / scale), -127, 127).to(torch.int8)


def compressed_psum(tree: Sequence[Any], residual: Sequence[Any],
                    axis_names: Tuple[str, ...], n_shards: int
                    ) -> Tuple[List[Any], List[Any]]:
    """All-reduce-mean the shards' trees (``tree[i]`` is shard i's) in
    int8 with error feedback over the ``axis_names`` shards.  Returns
    (each shard's mean tree, each shard's new residual)."""
    if len(tree) != len(residual):
        raise ValueError(f"{len(tree)} shards' trees, {len(residual)} "
                         "residuals")
    flat = [pytree.leaves(t) for t in tree]
    res = [pytree.leaves(r) for r in residual]
    means = [[] for _ in tree]
    new_res = [[] for _ in tree]
    for j in range(len(flat[0])):
        gs = [f[j] for f in flat]
        es = [g.to(torch.float32) + r[j] for g, r in zip(gs, res)]
        dev0 = es[0].device
        gmax = torch.stack([torch.max(torch.abs(e)).to(dev0) for e in es]
                           ).max()
        scale = torch.clamp(gmax / 127.0, min=1e-12)
        qs = [quantize_int8(e, scale.to(e.device)) for e in es]
        qsum = qs[0].to(torch.int32)
        for q in qs[1:]:
            qsum = qsum + q.to(dev0).to(torch.int32)
        mean = qsum.to(torch.float32) * scale / n_shards
        for i, (g, e, q) in enumerate(zip(gs, es, qs)):
            means[i].append(mean.to(g.dtype).to(g.device))
            new_res[i].append(e - q.to(torch.float32) * scale.to(e.device))
    return ([pytree.unflatten(t, m) for t, m in zip(tree, means)],
            [pytree.unflatten(t, r) for t, r in zip(tree, new_res)])


def init_residual(params: Any) -> Any:
    """Zeros in fp32 shaped as ``params`` (a pytree, or a module's
    reference-layout tree)."""
    if isinstance(params, torch.nn.Module):
        params = pytree.module_tree(params)
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def _shard_devices(mesh, data_axes: Tuple[str, ...]) -> List[torch.device]:
    """The device of each data shard: the grid with the data axes first,
    the first device along the others."""
    order = [mesh.axis_names.index(a) for a in data_axes]
    rest = [i for i in range(len(mesh.axis_names)) if i not in order]
    grid = np.transpose(mesh.devices, order + rest)
    n = int(np.prod([mesh.shape[a] for a in data_axes]))
    return list(grid.reshape(n, -1)[:, 0])


def make_ddp_train_step(mesh, data_axes: Tuple[str, ...],
                        loss_fn: Callable, optimizer) -> Callable:
    """Data-parallel train step with the int8-compressed gradient
    all-reduce: ``step(model, opt_state, residual, batch) -> (model,
    opt_state, residuals, stats)``.  The batch splits on its leading axis
    over the data shards; each shard's gradient comes from the model (or
    its copy on the shard's device); the weights take one optimizer
    update from the mean.  ``residual`` is one tree (every shard starts
    from it) or one per shard."""
    devices = _shard_devices(mesh, data_axes)
    n_shards = len(devices)
    replicas = {}

    def replica(model, dev):
        home = next(model.parameters()).device
        if dev == home:
            return model
        rep = replicas.get(dev)
        if rep is None:
            rep = replicas[dev] = copy.deepcopy(model).to(dev)
        else:
            rep.load_state_dict(model.state_dict())
        return rep

    def step(params, opt_state, residual, batch):
        if isinstance(residual, list):
            residuals = residual
        else:
            residuals = [pytree.tree_map(lambda r, d=dev: r.to(d, copy=True),
                                         residual) for dev in devices]
        grads = []
        for i, dev in enumerate(devices):
            shard = {}
            for k, v in batch.items():
                b = v.shape[0]
                assert b % n_shards == 0, (b, n_shards)
                shard[k] = v.reshape((n_shards, b // n_shards)
                                     + tuple(v.shape[1:]))[i].to(dev)
            model = replica(params, dev)
            _, _, g = loss_and_grads(loss_fn, model, shard)
            grads.append(pytree.module_tree(params, g))
        mean, residuals = compressed_psum(grads, residuals, data_axes,
                                          n_shards)
        ptree = pytree.module_tree(params)
        ptree, opt_state, stats = optimizer.update(mean[0], opt_state, ptree)
        pytree.load_module_tree(params, ptree)
        return params, opt_state, residuals, stats

    return step
