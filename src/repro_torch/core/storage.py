"""Cold-tier storage: pluggable dict-like backends and the block codec.

A copy of ``repro.core.storage`` (host-only code, copied so that the port
imports no module of the reference); the payload format is the
reference's, so a cold store written by either package is read by the
other.

The sliding window keeps the hot tier on the device.  With a cold store
attached (``QueryContext(cold_store=...)``) an evicted ingest block is
first re-packed into a self-contained payload (its own postings bitmap,
one word row per 32 evicted docs, plus the per-term document
frequencies) and written to the store under a monotonically increasing
block key.  A ``scope="all-time"`` materialization stacks those word
rows under the live index (co-occurrence counts are additive over
disjoint doc sets) and answers over every document the index has seen.

The backend contract is a ``MutableMapping[str, bytes]``: a plain ``{}``
is a valid in-memory store, :class:`FileStorage` the durable single-node
one (each block committed through the atomic-write protocol), and any
other client wrapped to the mapping interface drops in unchanged.
:func:`make_storage` builds one from a config dict.
"""
from __future__ import annotations

import io
import os
from collections.abc import MutableMapping
from typing import Dict, Iterator, NamedTuple, Optional

import numpy as np

from repro_torch.core.atomic_io import atomic_write_bytes


class ColdBlock(NamedTuple):
    """One evicted ingest block, self-contained and re-queryable."""

    packed: np.ndarray     # (ceil(n_docs/32), vocab) uint32 postings bitmap
    doc_freq: np.ndarray   # (vocab,) int32 df of the block's docs
    n_docs: int            # docs in the block
    vocab: int             # vocab size AT EVICTION (may be < the live V now)


def encode_block(block: ColdBlock) -> bytes:
    """Serialize a ColdBlock to a self-describing bytes payload (npz)."""
    buf = io.BytesIO()
    np.savez(buf, packed=np.ascontiguousarray(block.packed, np.uint32),
             doc_freq=np.ascontiguousarray(block.doc_freq, np.int32),
             n_docs=np.int64(block.n_docs), vocab=np.int64(block.vocab))
    return buf.getvalue()


def decode_block(data: bytes) -> ColdBlock:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        return ColdBlock(packed=np.asarray(z["packed"], np.uint32),
                         doc_freq=np.asarray(z["doc_freq"], np.int32),
                         n_docs=int(z["n_docs"]), vocab=int(z["vocab"]))


class FileStorage(MutableMapping):
    """Durable dict-like store: one file per key under ``path``.

    Writes commit through :func:`repro_torch.core.atomic_io.atomic_write_bytes`
    (temp -> fsync -> rename -> fsync parent), so a crash mid-spill never
    leaves a torn block — the key either exists complete or not at all.
    Keys are restricted to ``[A-Za-z0-9._-]`` so a key can never escape
    the directory.
    """

    _SUFFIX = ".bin"

    def __init__(self, path: str):
        self.path = os.fspath(path)
        os.makedirs(self.path, exist_ok=True)

    def _file(self, key: str) -> str:
        if not key or any(c not in _SAFE_KEY_CHARS for c in key):
            raise KeyError(f"invalid cold-store key {key!r} "
                           "(allowed: letters, digits, '.', '_', '-')")
        return os.path.join(self.path, key + self._SUFFIX)

    def __setitem__(self, key: str, value: bytes) -> None:
        atomic_write_bytes(self._file(key), bytes(value))

    def __getitem__(self, key: str) -> bytes:
        try:
            with open(self._file(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(key) from None

    def __delitem__(self, key: str) -> None:
        try:
            os.unlink(self._file(key))
        except FileNotFoundError:
            raise KeyError(key) from None

    def __iter__(self) -> Iterator[str]:
        for fn in sorted(os.listdir(self.path)):
            if fn.endswith(self._SUFFIX) and not fn.startswith("."):
                yield fn[:-len(self._SUFFIX)]

    def __len__(self) -> int:
        return sum(1 for _ in self)


_SAFE_KEY_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-")


def make_storage(config: Optional[Dict] = None) -> MutableMapping:
    """Build a cold-store backend from a datasketch-style config dict:
    ``{"type": "dict"}`` (default) or ``{"type": "file", "path": dir}``.
    Any existing MutableMapping passes through unchanged, so callers can
    hand in a Redis-backed mapping directly."""
    if config is None:
        return {}
    if isinstance(config, MutableMapping) and "type" not in config:
        return config
    kind = config.get("type", "dict")
    if kind == "dict":
        return {}
    if kind == "file":
        path = config.get("path")
        if not path:
            raise ValueError("file storage config needs a 'path' directory")
        return FileStorage(path)
    raise ValueError(f"unknown cold-store type {kind!r} "
                     "(supported: 'dict', 'file')")
