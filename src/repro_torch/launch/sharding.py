"""Logical-axis sharding: models name their tensors' axes logically and the
launch layer binds the names to physical mesh axes (MaxText-style).  The
rule table and its resolution are copies of ``repro.launch.sharding``'s.

Physical mesh axes: ("pod", "data", "model") multi-pod, ("data", "model")
single-pod (see :mod:`repro_torch.launch.mesh`).

The port's own small ``PartitionSpec`` (``P``, a tuple with one entry a
tensor dim) and ``NamedSharding(mesh, spec)`` stand where jax's do, with
the names jax's shardings use: ``shard_shape(shape)`` and
``devices_indices_map(shape)``.  A tensor laid out over a grid of several
devices is a :class:`ShardedTensor`: its shards by grid position, and a
gather onto one device.

Two departures (ROADMAP.md §3): :func:`constrain` resolves and checks the
spec and returns ``x`` itself, since a tensor in one process lives on one
device and there is no partitioner to hand the constraint to (the port's
models do not call it); and there is no ``shard_map_compat`` — the port's
sharded execution is :mod:`repro_torch.core.distributed`'s
single-controller loop over the shards.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.launch.mesh import DeviceMesh

Axis = Union[str, None, Tuple[str, ...]]

# logical axis -> physical mesh axes (tuple = axis product)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),        # data parallel
    "seq": ("model",),               # sequence parallelism between blocks
    "kv_seq": ("data", "model"),     # long-context KV cache sequence sharding
    "heads": ("model",),             # tensor parallel attention
    "kv_heads": ("model",),
    "ff": ("model",),                # tensor parallel FFN
    "vocab": ("model",),             # tensor parallel embedding / lm head
    "experts": ("model",),           # expert parallel
    "embed": (),                     # d_model stays replicated (TP activations)
    "fsdp": ("data",),               # param/opt-state FSDP axis
    "edges": ("pod", "data"),        # GNN edge partition
    "nodes": (),                     # GNN node tensors replicated
    "feat": ("model",),              # GNN/recsys feature dim
    "rows": ("model",),              # embedding-table row sharding
    "docs": ("pod", "data"),         # packed index: doc-word axis
    "terms": ("model",),             # packed index: vocabulary axis
    "cooc_row": ("pod", "data"),     # co-occurrence matrix row axis (V x V out)
    "cand": ("pod", "data", "model"),  # retrieval candidate axis
}


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), a mesh axis name, or a
    tuple of names (the dim split over their product, major first)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _dim_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A :class:`PartitionSpec` bound to a mesh.  ``devices_indices_map``
    keys the shards by grid position (a tuple of mesh indices): a grid may
    hold one device more than once (four shards of one card), where jax's
    keys by device."""

    def __init__(self, mesh: DeviceMesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)
        for entry in self.spec:
            for a in _dim_axes(entry):
                if a not in mesh.shape:
                    raise ValueError(f"{self.spec} names axis {a!r}, not in "
                                     f"the mesh's {mesh.axis_names}")

    def _splits(self, shape: Sequence[int]) -> Tuple[Tuple[str, ...], ...]:
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec} has more entries than the "
                             f"{len(shape)} dims of {tuple(shape)}")
        axes = [_dim_axes(e) for e in self.spec]
        axes += [()] * (len(shape) - len(axes))
        for n, ax in zip(shape, axes):
            k = math.prod(self.mesh.shape[a] for a in ax)
            if n % k:
                raise ValueError(f"dim {n} of {tuple(shape)} does not split "
                                 f"{k} ways over {ax} ({self.spec})")
        return tuple(axes)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one device's shard of a ``shape`` tensor."""
        return tuple(n // math.prod(self.mesh.shape[a] for a in ax)
                     for n, ax in zip(shape, self._splits(shape)))

    def devices_indices_map(self, shape: Sequence[int]
                            ) -> Dict[Tuple[int, ...], Tuple[slice, ...]]:
        """Grid position -> the slices of a ``shape`` tensor held there
        (``slice(None)`` where a dim is whole)."""
        splits = self._splits(shape)
        names = self.mesh.axis_names
        out = {}
        for pos in np.ndindex(self.mesh.devices.shape):
            at = dict(zip(names, pos))
            idx = []
            for n, ax in zip(shape, splits):
                if not ax:
                    idx.append(slice(None))
                    continue
                k, part = 1, 0
                for a in ax:
                    part = part * self.mesh.shape[a] + at[a]
                    k *= self.mesh.shape[a]
                step = n // k
                idx.append(slice(part * step, (part + 1) * step))
            out[tuple(pos)] = tuple(idx)
        return out

    def device_at(self, pos: Tuple[int, ...]) -> torch.device:
        return self.mesh.devices[pos]

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec})"


class ShardedTensor:
    """A tensor held as shards over a mesh's grid: ``shards`` maps each grid
    position to its slice (:meth:`NamedSharding.devices_indices_map`), on
    that position's device.  ``gather`` assembles the whole tensor on one
    device."""

    def __init__(self, shards: Dict[Tuple[int, ...], torch.Tensor],
                 sharding: NamedSharding, shape: Sequence[int],
                 dtype: torch.dtype):
        self.shards = shards
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first position's)."""
        first = next(iter(self.shards))
        dev = self.sharding.device_at(first) if device is None \
            else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for pos, idx in self.sharding.devices_indices_map(self.shape).items():
            out[idx] = self.shards[pos].to(dev)
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype}"
                f", {self.sharding})")


def make_from_callback(shape: Sequence[int], sharding: NamedSharding,
                       read: Callable[[Tuple[slice, ...]], torch.Tensor]):
    """``jax.make_array_from_callback``: ``read(index)`` gives the host
    tensor of each shard's slice, placed on its position's device (read
    once for each distinct device and slice).  Where the sharding puts the
    whole tensor on one device, the result is that plain tensor; else a
    :class:`ShardedTensor`."""
    imap = sharding.devices_indices_map(shape)
    devs = {sharding.device_at(pos) for pos in imap}
    full = all(s.indices(n)[:2] == (0, n) for idx in imap.values()
               for s, n in zip(idx, shape))
    if len(devs) == 1 and full:
        return read(tuple(slice(None) for _ in shape)).to(devs.pop())
    placed: Dict[Tuple, torch.Tensor] = {}
    shards = {}
    for pos, idx in imap.items():
        dev = sharding.device_at(pos)
        key = (dev, tuple((s.start, s.stop) for s in idx))
        if key not in placed:
            placed[key] = read(idx).to(dev)
        shards[pos] = placed[key]
    dtype = next(iter(shards.values())).dtype
    return ShardedTensor(shards, sharding, shape, dtype)


# ---------------------------------------------------------------------------
# The active rules
# ---------------------------------------------------------------------------


class _Ctx:
    def __init__(self, mesh: DeviceMesh, rules: Dict[str, Tuple[str, ...]]):
        self.mesh = mesh
        self.rules = rules


_ACTIVE: contextvars.ContextVar[Optional[_Ctx]] = contextvars.ContextVar(
    "sharding_ctx", default=None)


@contextlib.contextmanager
def axis_rules(mesh: DeviceMesh,
               rules: Optional[Dict[str, Tuple[str, ...]]] = None
               ) -> Iterator[None]:
    """Activate logical->physical sharding for the enclosed region."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    tok = _ACTIVE.set(_Ctx(mesh, merged))
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


def _resolve_axis(ctx: _Ctx, axis: Axis, dim_size: int,
                  used: set) -> Optional[Tuple[str, ...]]:
    """Map one logical axis to mesh axes, dropping axes that don't divide
    the dim or are already consumed by an earlier dim of the same tensor."""
    if axis is None:
        return None
    names = (axis,) if isinstance(axis, str) else axis
    phys: list = []
    for n in names:
        for m in ctx.rules.get(n, ()):
            if m in ctx.mesh.shape:
                phys.append(m)
    if not phys:
        return None
    total = 1
    kept = []
    for m in phys:
        if m in kept or m in used:
            continue
        sz = ctx.mesh.shape[m]
        if dim_size % (total * sz) == 0:
            kept.append(m)
            total *= sz
    return tuple(kept) or None


def logical_to_spec(axes: Sequence[Axis], shape: Sequence[int]) -> P:
    """Resolve logical axes to a PartitionSpec under the active context.

    Indivisible dims degrade to replication per-mesh-axis (e.g. qwen's 40
    heads on a 16-way model axis); a mesh axis is used by at most one dim
    (first dim in ``axes`` order wins).
    """
    ctx = _ACTIVE.get()
    assert ctx is not None
    parts = []
    used: set = set()
    for ax, n in zip(axes, shape):
        r = _resolve_axis(ctx, ax, n, used)
        if r is None:
            parts.append(None)
        elif len(r) == 1:
            parts.append(r[0])
            used.add(r[0])
        else:
            parts.append(tuple(r))
            used.update(r)
    return P(*parts)


def _shape_of(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def named_sharding(axes: Sequence[Axis], shape) -> NamedSharding:
    """One NamedSharding from logical axes + a concrete shape (or tensor)."""
    ctx = _ACTIVE.get()
    assert ctx is not None
    return NamedSharding(ctx.mesh, logical_to_spec(axes, _shape_of(shape)))


def constrain(x: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    """Identity outside a context.  Inside, the spec is resolved and checked
    against ``x``'s shape, and ``x`` itself is returned: one process holds
    a tensor on one device, and no partitioner takes the constraint."""
    ctx = _ACTIVE.get()
    if ctx is None:
        return x
    NamedSharding(ctx.mesh, logical_to_spec(axes, x.shape)).shard_shape(
        x.shape)
    return x


def spec_tree(specs_logical, shapes):
    """Map a tree of logical-axis tuples + matching shapes (or tensors) to
    PartitionSpecs."""
    return pytree.tree_map(
        lambda ax, sh: logical_to_spec(ax, _shape_of(sh)),
        specs_logical, shapes, is_leaf=pytree.is_logical)


def sharding_tree(specs_logical, shapes):
    """Same but returns NamedSharding leaves."""
    ctx = _ACTIVE.get()
    assert ctx is not None
    return pytree.tree_map(
        lambda ax, sh: NamedSharding(ctx.mesh,
                                     logical_to_spec(ax, _shape_of(sh))),
        specs_logical, shapes, is_leaf=pytree.is_logical)


def active_mesh() -> Optional[DeviceMesh]:
    ctx = _ACTIVE.get()
    return ctx.mesh if ctx else None
