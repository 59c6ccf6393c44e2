"""Atomic checkpoints in the reference's on-disk format: a copy of
``repro.train.checkpoint``, so a checkpoint saved by either package
restores in the other.

Layout::

    <dir>/step_000123/
        manifest.json     {"step", "leaves": [{"key", "file", "raw",
                          "shape", "dtype"}, ...]}
        arr_<i>.npy       one file per leaf (np.save, mmap-able)

Each leaf's ``key`` is ``jax.tree_util.keystr`` of its path in the saved
tree (``[0]['table']``, ``[1]['m']['table']``;
:func:`repro_torch.pytree.keystr`), leaves in ``jax.tree_util``'s order.
A dtype numpy cannot store natively (bf16) is saved as its raw bytes,
``"raw": true``, with the logical dtype in the manifest.

* **atomic commit**: written to ``step_X.tmp``, every file fsync'd, then
  renamed into place and the parent directory fsync'd
  (:func:`repro_torch.core.atomic_io.commit_dir`);
* **keep-last-N** garbage collection;
* **async save**: every leaf is copied to the host on the caller's thread
  (a CPU tensor too), and only the files are written on a worker thread,
  so a training step that updates the weights in place right after
  ``save`` returns cannot change what is written.

``restore`` rebuilds the tree on ``device`` (default: each template
leaf's), or, with ``shardings=`` (a tree of
:class:`repro_torch.launch.sharding.NamedSharding` matching the
template), shard by shard: each grid position's slice is read from the
memory-mapped file and placed on its device (the reference's
reshard-on-restore).  A leaf whose sharding puts it whole on one device
is a plain tensor; any other a
:class:`repro_torch.launch.sharding.ShardedTensor`.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.core.atomic_io import commit_dir

_NATIVE = {"float64", "float32", "float16", "int64", "int32", "int16", "int8",
           "uint64", "uint32", "uint16", "uint8", "bool"}


#: numpy's unsigned integer of each byte width: a raw leaf's bits
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _host(t: torch.Tensor) -> Tuple[np.ndarray, bool, List[int], str]:
    """(the array to write, raw, shape, dtype name) of a leaf, copied."""
    name = _dtype_name(t.dtype)
    h = t.detach().to("cpu", copy=True)
    raw = name not in _NATIVE
    arr = h.contiguous().reshape(-1).view(torch.uint8).numpy() if raw \
        else h.numpy()
    return arr, raw, list(h.shape), name


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
         blocking: bool = True) -> threading.Thread | None:
    """Save a pytree of tensors.  blocking=False -> the files are written
    on a worker thread (returned); the host copy is taken before that."""
    host = [(pytree.keystr(path), *_host(leaf))
            for path, leaf in pytree.flatten_with_path(tree)]

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        for i, (k, arr, raw, shape, dtype) in enumerate(host):
            np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)  # cooclint: disable=COOC001 -- staged write; commit_dir below fsyncs + renames
            manifest["leaves"].append(
                {"key": k, "file": f"arr_{i}.npy", "raw": raw,
                 "shape": shape, "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:  # cooclint: disable=COOC001 -- staged write; commit_dir below fsyncs + renames
            json.dump(manifest, f)  # cooclint: disable=COOC001 -- staged write; commit_dir below fsyncs + renames
        commit_dir(tmp, final)
        _gc(ckpt_dir, keep)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)  # cooclint: disable=COOC001 -- keep= GC of superseded committed checkpoints


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                out.append(int(d[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, template: Any, *, step: Optional[int] = None,
            device=None, shardings: Any = None) -> Tuple[Any, int]:
    """Restore into the structure of ``template`` (a pytree of tensors):
    each leaf in the manifest's dtype, on ``device`` or, without one, on
    its template leaf's device.

    shardings: optional tree of NamedSharding matching ``template``: the
    leaves are rebuilt shard by shard (reshard-on-restore), and ``device``
    must not be given."""
    if shardings is not None and device is not None:
        raise ValueError("restore takes shardings= or device=, not both")
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {l["key"]: l for l in manifest["leaves"]}

    shard_flat = None
    if shardings is not None:
        from repro_torch.launch.sharding import make_from_callback
        shard_flat = [s for _, s in pytree.flatten_with_path(shardings)]

    leaves = []
    for i, (path, tmpl) in enumerate(pytree.flatten_with_path(template)):
        meta = by_key[pytree.keystr(path)]
        arr = np.load(os.path.join(d, meta["file"]), mmap_mode="r")
        shape = tuple(meta["shape"])

        def read(idx, arr=arr, meta=meta, shape=shape):
            """The host tensor of the leaf's slice ``idx`` (all of it for
            an index of full slices), read from the mapped file."""
            if meta.get("raw"):
                dt = getattr(torch, meta["dtype"])
                bits = arr.view(_UINT[dt.itemsize]).reshape(shape)
                return torch.from_numpy(np.array(bits[idx])).view(dt)
            return torch.from_numpy(np.array(arr[idx]))

        if shard_flat is not None:
            leaves.append(make_from_callback(shape, shard_flat[i], read))
        else:
            full = read(tuple(slice(None) for _ in shape))
            leaves.append(full.to(device if device is not None
                                  else tmpl.device))
    return pytree.unflatten(template, leaves), step
