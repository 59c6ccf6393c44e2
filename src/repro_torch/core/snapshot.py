"""Durable snapshot and restore of the full index state, in the
reference's format.

Mirrors ``repro.core.snapshot``.  :func:`save_context` captures the packed
postings, ``doc_freq`` and ``n_docs``, the streaming ring (live blocks,
tail, window, stranded count, eviction total), every named scope bitmap
with its version counter, the cold tier's spilled blocks and the MinHash
sketch state (one signature per config and live block);
:func:`load_context` restores a context that answers every query exactly
like the live one, with derived caches rebuilt lazily, and keeps streaming
without rehashing any block it already sketched.  ``CoocIndex.save`` and
``.load`` (:mod:`repro_torch.api`) carry the lexicon, doc timestamps,
time-bucket state and engine defaults through ``extra_arrays`` /
``extra_meta``.

The format is the reference's, byte for byte, so either package reads
what the other wrote::

    <path>/
        CURRENT                   # pointer file: name of the live snapshot
        snap-00000007/
            manifest.json         # format + version, blob table with
                                  # sha256, scalar state ("meta")
            arr_0000.npy ...      # one plain .npy per array blob

Bitmaps and signatures are uint32 on disk (the port's int32 patterns,
viewed), blocks int64, cold payloads uint8.  The meta ``dtype`` names the
reference's dense dtype: a restored context carries the string it read,
a context the port built writes ``"bfloat16"``; the port's ``x_dense`` is
int8 either way.

Commit protocol (:mod:`repro_torch.core.atomic_io`): the ``snap-<seq>``
directory is populated under a temporary name, every file fsync'd, the
directory renamed into place and its parent fsync'd, and only then is
``CURRENT`` swung to it by an atomic pointer write.  A crash at any step
leaves ``CURRENT`` naming a complete, checksummed snapshot.  Superseded
snapshots are removed after the pointer commit (``keep=``).

Unlike the reference, each ``.npy`` is streamed to its file while its
sha256 is computed, and read back into one buffer that the array then
uses: at the CSL scale no blob is held twice on the host.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import time
from collections import deque
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.atomic_io import atomic_write_text, commit_dir
from repro_torch.core.inverted_index import PackedIndex, from_uint32, to_uint32
from repro_torch.device import resolve_device

SNAPSHOT_FORMAT = "cooc-snapshot"
SNAPSHOT_VERSION = 1

_CURRENT = "CURRENT"
_SNAP_PREFIX = "snap-"


class SnapshotError(RuntimeError):
    """Missing, torn, corrupt, or incompatible snapshot."""


# -- generic blob-store layer ------------------------------------------------

def _snap_seqs(path: str):
    out = []
    if os.path.isdir(path):
        for d in os.listdir(path):
            if d.startswith(_SNAP_PREFIX):
                try:
                    out.append(int(d[len(_SNAP_PREFIX):]))
                except ValueError:
                    pass
    return sorted(out)


class _HashingWriter:
    """A write-only file wrapper that feeds every byte to a sha256.  Not a
    real file to numpy, so ``np.save`` writes through ``write`` in
    bounded chunks, the same bytes it writes into a ``BytesIO``."""

    def __init__(self, f):
        self._f = f
        self.sha = hashlib.sha256()

    def write(self, data) -> int:
        self.sha.update(data)
        return self._f.write(data)


def write_snapshot(path: str, arrays: Dict[str, np.ndarray], meta: dict, *,
                   keep: int = 2) -> str:
    """Commit one snapshot generation under ``path`` and swing ``CURRENT``
    to it.  ``arrays`` maps blob names to host arrays; ``meta`` is the
    JSON-able scalar state.  Returns the committed snapshot directory."""
    path = os.fspath(path)
    os.makedirs(path, exist_ok=True)
    seq = (_snap_seqs(path)[-1] + 1) if _snap_seqs(path) else 0
    name = f"{_SNAP_PREFIX}{seq:08d}"
    final = os.path.join(path, name)
    tmp = os.path.join(path, f".{name}.tmp-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)  # cooclint: disable=COOC001 -- clears a leftover staging dir from a crashed writer
    os.makedirs(tmp)
    try:
        blobs = {}
        for i, (bname, arr) in enumerate(arrays.items()):
            arr = np.ascontiguousarray(arr)
            fn = f"arr_{i:04d}.npy"
            with open(os.path.join(tmp, fn), "wb") as f:  # cooclint: disable=COOC001 -- staged write; commit_dir below fsyncs + renames
                out = _HashingWriter(f)
                np.save(out, arr, allow_pickle=False)
            blobs[bname] = {"file": fn, "sha256": out.sha.hexdigest(),
                            "shape": list(arr.shape),
                            "dtype": str(arr.dtype)}
        manifest = {"format": SNAPSHOT_FORMAT, "version": SNAPSHOT_VERSION,
                    "created_unix": time.time(), "blobs": blobs, "meta": meta}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:  # cooclint: disable=COOC001 -- staged write; commit_dir below fsyncs + renames
            json.dump(manifest, f, indent=2)  # cooclint: disable=COOC001 -- staged write; commit_dir below fsyncs + renames
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)  # cooclint: disable=COOC001 -- error-path cleanup of the uncommitted staging dir
        raise
    # fsync files -> rename dir -> fsync parent; only then publish through
    # the pointer (its own temp -> fsync -> rename -> fsync commit)
    commit_dir(tmp, final)
    atomic_write_text(os.path.join(path, _CURRENT), name + "\n")
    for seq_old in _snap_seqs(path)[:-max(int(keep), 1)]:
        old = f"{_SNAP_PREFIX}{seq_old:08d}"
        if old != name:
            shutil.rmtree(os.path.join(path, old), ignore_errors=True)  # cooclint: disable=COOC001 -- keep= GC of superseded committed snapshots
    return final


def _read_npy(path: str, expect_sha: str, bname: str,
              verify: bool) -> np.ndarray:
    """One ``.npy`` read into one buffer, its sha256 checked against the
    manifest's, and the array built over that buffer (no second copy)."""
    size = os.path.getsize(path)
    data = bytearray(size)
    with open(path, "rb") as f:
        got = f.readinto(data)
    if got != size:
        raise SnapshotError(f"short read of blob {bname!r} ({path})")
    if verify:
        sha = hashlib.sha256(data).hexdigest()
        if sha != expect_sha:
            raise SnapshotError(
                f"checksum mismatch on blob {bname!r} "
                f"({os.path.basename(path)}): manifest {expect_sha[:12]}…, "
                f"file {sha[:12]}…")
    head = io.BytesIO(memoryview(data)[:min(size, 1 << 16)])
    try:
        major, _ = np.lib.format.read_magic(head)
        read_header = (np.lib.format.read_array_header_1_0 if major == 1
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(head)
    except ValueError as e:
        raise SnapshotError(f"blob {bname!r} is not a .npy file: {e}") from e
    if dtype.hasobject:
        raise SnapshotError(f"blob {bname!r} holds Python objects")
    count = int(np.prod(shape, dtype=np.int64))
    arr = np.frombuffer(data, dtype=dtype, count=count, offset=head.tell())
    return arr.reshape(shape, order="F" if fortran else "C")


def read_snapshot(path: str, *, verify: bool = True
                  ) -> Tuple[Dict[str, np.ndarray], dict]:
    """Load the CURRENT snapshot under ``path``: (arrays, meta).  With
    ``verify`` every blob's sha256 is checked against the manifest; a
    mismatch (torn write, bit rot) raises :class:`SnapshotError`."""
    path = os.fspath(path)
    cur = os.path.join(path, _CURRENT)
    if not os.path.exists(cur):
        raise SnapshotError(f"no snapshot under {path!r} (no {_CURRENT})")
    with open(cur) as f:
        name = f.read().strip()
    d = os.path.join(path, name)
    man_path = os.path.join(d, "manifest.json")
    if not os.path.exists(man_path):
        raise SnapshotError(f"{_CURRENT} names {name!r} but it has no "
                            "manifest — torn snapshot")
    with open(man_path) as f:
        manifest = json.load(f)
    if manifest.get("format") != SNAPSHOT_FORMAT:
        raise SnapshotError(f"not a {SNAPSHOT_FORMAT} "
                            f"(format={manifest.get('format')!r})")
    if int(manifest.get("version", -1)) > SNAPSHOT_VERSION:
        raise SnapshotError(
            f"snapshot version {manifest.get('version')} is newer than "
            f"this build supports ({SNAPSHOT_VERSION})")
    arrays = {bname: _read_npy(os.path.join(d, b["file"]), b["sha256"],
                               bname, verify)
              for bname, b in manifest["blobs"].items()}
    return arrays, manifest["meta"]


# -- QueryContext <-> snapshot ----------------------------------------------

def context_state(ctx) -> Tuple[Dict[str, np.ndarray], dict]:
    """Serialize a QueryContext to (arrays, meta), the reference's blobs
    and keys: packed postings + df + n_docs, the streaming ring, every
    scope bitmap + version, the cold tier's payloads and the sketch state.
    Derived caches (x_dense, packed_t, device scope bitmaps, the artifact
    cache) are not captured: a restore rebuilds them lazily."""
    idx = ctx.index
    arrays: Dict[str, np.ndarray] = {
        "packed": np.ascontiguousarray(to_uint32(idx.packed)),
        "doc_freq": idx.doc_freq.cpu().numpy().astype(np.int32, copy=False),
    }
    for i, blk in enumerate(ctx._blocks):
        arrays[f"block_{i:04d}"] = np.asarray(blk, np.int64)
    scope_names = list(ctx.scope_names())
    for i, name in enumerate(scope_names):
        arrays[f"scope_{i:04d}"] = np.asarray(ctx._scope_host(name),
                                              np.uint32)
    cold_keys = []
    if ctx._cold is not None:
        for i, key in enumerate(sorted(ctx._cold)):
            arrays[f"cold_{i:04d}"] = np.frombuffer(ctx._cold[key], np.uint8)
            cold_keys.append(key)
    # one signature blob per (config, live block), keyed by position
    # against block_NNNN: block identity is re-established on restore
    sketch_cfgs = []
    block_pos = {id(b): i for i, b in enumerate(ctx._blocks)}
    for ci, cfg in enumerate(sorted(ctx._sketch_blocks)):
        saved = []
        for ent in ctx._sketch_blocks[cfg]:
            bi = block_pos.get(id(ent[0]))
            if bi is None:
                continue
            arrays[f"sketch_{ci:02d}_{bi:04d}"] = np.ascontiguousarray(
                to_uint32(ent[1]))
            saved.append(bi)
        sketch_cfgs.append({"num_perm": int(cfg[0]), "seed": int(cfg[1]),
                            "blocks": saved})
    meta = {
        "kind": "context",
        "n_docs": int(idx.n_docs),
        "dtype": str(ctx._dtype),
        "epoch": int(ctx.epoch),
        "ring_tail": int(ctx._ring_tail),
        "window": ctx._window,
        "stranded": int(ctx._stranded),
        "evicted_docs_total": int(ctx.evicted_docs_total),
        "unpack_count": int(ctx.unpack_count),
        "n_blocks": len(ctx._blocks),
        "scopes": scope_names,
        "scope_ver": dict(ctx._scope_ver),
        "cold_seq": int(ctx._cold_seq),
        "cold_keys": cold_keys,
        "sketch_cfgs": sketch_cfgs,
    }
    return arrays, meta


def context_from_state(arrays: Dict[str, np.ndarray], meta: dict, *,
                       device="cuda", mesh=None, cold_store=None):
    """Rebuild a port QueryContext from (arrays, meta), as written by
    :func:`context_state` here or ``repro.core.snapshot.context_state``:
    ``packed`` (uint32), ``doc_freq``, ``block_NNNN``, ``scope_NNNN``,
    the cold payloads ``cold_NNNN`` and the signatures
    ``sketch_CC_BBBB``; ``meta`` holds the scalar state.  The uint32
    bitmaps and signatures are viewed as int32.

    ``cold_store`` receives the state's cold payloads (a fresh dict when
    omitted and the state has any); a key whose payload is not among
    ``arrays`` must already be in ``cold_store`` (say a directory the
    other package spilled to).  ``mesh`` is a restore-time choice, not
    state: one snapshot restores onto one device or onto any query mesh
    (whose first device ``device`` must name), with identical answers."""
    from repro_torch.core.query_context import QueryContext
    dev = resolve_device(device)
    index = PackedIndex(
        from_uint32(arrays["packed"], dev),
        torch.from_numpy(np.array(arrays["doc_freq"], np.int32)).to(dev),
        int(meta["n_docs"]))
    ctx = QueryContext(index, device=dev, mesh=mesh)
    ctx._dtype = str(meta.get("dtype", "bfloat16"))
    ctx._blocks = deque(np.asarray(arrays[f"block_{i:04d}"], np.int64)
                        for i in range(int(meta["n_blocks"])))
    ctx._ring_tail = int(meta["ring_tail"])
    ctx._window = None if meta["window"] is None else int(meta["window"])
    ctx._stranded = int(meta["stranded"])
    ctx.evicted_docs_total = int(meta["evicted_docs_total"])
    ctx.unpack_count = int(meta.get("unpack_count", 0))
    ctx.epoch = int(meta["epoch"])
    ctx._scopes = {name: np.ascontiguousarray(arrays[f"scope_{i:04d}"],
                                              np.uint32)
                   for i, name in enumerate(meta["scopes"])}
    ctx._scope_ver = {k: int(v) for k, v in meta.get("scope_ver", {}).items()}
    cold_keys = meta.get("cold_keys", [])
    if cold_keys and cold_store is None:
        cold_store = {}
    for i, key in enumerate(cold_keys):
        blob = arrays.get(f"cold_{i:04d}")
        if blob is not None:
            cold_store[key] = np.asarray(blob).tobytes()
        elif key not in cold_store:
            raise KeyError(f"cold block {key!r} is neither in the state's "
                           "arrays nor in cold_store")
    ctx._cold = cold_store
    ctx._cold_seq = int(meta.get("cold_seq", 0))
    blocks = list(ctx._blocks)
    for ci, cfg in enumerate(meta.get("sketch_cfgs", [])):
        ctx._sketch_blocks[(int(cfg["num_perm"]), int(cfg["seed"]))] = [
            (blocks[int(bi)],
             from_uint32(arrays[f"sketch_{ci:02d}_{int(bi):04d}"], dev))
            for bi in cfg["blocks"]]
    return ctx


def save_context(ctx, path: str, *, extra_arrays=None, extra_meta=None,
                 keep: int = 2) -> str:
    """Snapshot ``ctx`` under ``path`` (see the module docstring for the
    layout and the commit protocol).  ``extra_arrays`` / ``extra_meta``
    let a higher layer (``CoocIndex.save``) ride its state in the same
    atomic commit; extra meta keys overlay the context's."""
    arrays, meta = context_state(ctx)
    if extra_arrays:
        clash = set(extra_arrays) & set(arrays)
        if clash:
            raise ValueError(f"extra_arrays collide with context blobs: "
                             f"{sorted(clash)}")
        arrays.update(extra_arrays)
    if extra_meta:
        meta.update(extra_meta)
    return write_snapshot(path, arrays, meta, keep=keep)


def load_context(path: str, *, device="cuda", cold_store=None,
                 verify: bool = True, mesh=None):
    """Restore the CURRENT snapshot's QueryContext onto ``device`` (bare
    context snapshots and ``CoocIndex`` snapshots alike: the context
    payload is identical), or onto the query ``mesh`` whose first device
    it is."""
    arrays, meta = read_snapshot(path, verify=verify)
    return context_from_state(arrays, meta, device=device, mesh=mesh,
                              cold_store=cold_store)
