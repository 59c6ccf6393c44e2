"""QueryContext — the packed index plus its epoch-versioned artifacts.

Mirrors ``repro.core.query_context`` in append mode: the context owns the
packed index on one device and builds its derived artifacts lazily, once
per ingest epoch —

* ``x_dense()``      the dense int8 incidence (the gemm method's and the
  co-occurrence kernel's operand), stored term-major and built in term
  chunks; ``unpack_count`` counts its builds;
* ``packed_t()``     the transposed postings (V, W);
* ``packed_t_pad()`` the transposed postings padded to V % 8 == 0 and
  W % 128 == 0 (the reference's fused level-step operand; here the mask
  rows of materialization), padded once per epoch;

plus named document scopes (``(W,)`` bitmaps ANDed into the seed filters),
the all-ones ``full_mask`` (the unscoped scope operand), a generic
epoch-checked artifact cache, and ingest with a host-side capacity check.

The sliding window, the cold tier and the device mesh are not ported yet
(``ROADMAP.md``); asking for them raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.inverted_index import (
    PackedIndex,
    dense_operand,
    from_uint32,
    grow_capacity,
    grow_vocab,
    ingest_at,
    pack_docs,
    slots_bitmap,
)
from repro_torch.core.query import get_count_method
from repro_torch.device import resolve_device


class CapacityError(ValueError):
    """Ingest would overflow the packed index's doc capacity."""


def not_ported(what: str) -> NotImplementedError:
    """The error every not-yet-ported surface of the port raises."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; see ROADMAP.md "
        "(modules still to port)")


def pad_transposed(packed: torch.Tensor) -> torch.Tensor:
    """(W, V) postings -> (V_pad, W_pad) transposed, V padded to a multiple
    of 8 and W to a multiple of 128 with zero bits."""
    w, v = packed.shape
    out = packed.new_zeros((v + (-v) % 8, w + (-w) % 128))
    out[:v, :w] = packed.T
    return out


class QueryContext:
    """Packed index + epoch-versioned caches, on one device."""

    def __init__(self, index: PackedIndex, *, device="cuda",
                 window: Optional[int] = None, mesh=None, cold_store=None):
        if window is not None:
            raise not_ported("the sliding window (window=)")
        if cold_store is not None:
            raise not_ported("the cold tier (cold_store=)")
        if mesh is not None:
            raise not_ported("sharded execution (mesh=)")
        self.device = resolve_device(device)
        self._index = PackedIndex(index.packed.to(self.device),
                                  index.doc_freq.to(self.device),
                                  int(index.n_docs))
        self.epoch = 0
        self.unpack_count = 0   # monitoring: dense rebuilds == ingest epochs
        self._cache: Dict[str, Tuple[int, torch.Tensor]] = {}
        # generic epoch-versioned artifact cache: key -> (epoch, version, value)
        self._artifact_cache: Dict[Tuple, Tuple[int, int, object]] = {}
        self._scope_ver: Dict[str, int] = {}
        n0 = self._index.n_docs
        self._blocks = [np.arange(n0, dtype=np.int64)] if n0 > 0 else []
        self._scopes: Dict[str, np.ndarray] = {}
        self._scope_dev: Dict[str, Tuple[int, torch.Tensor]] = {}
        self._full_mask: Optional[torch.Tensor] = None

    @classmethod
    def from_docs(cls, doc_terms: Sequence[Sequence[int]], vocab_size: int, *,
                  capacity: Optional[int] = None, device="cuda",
                  window: Optional[int] = None, mesh=None,
                  cold_store=None) -> "QueryContext":
        dev = resolve_device(device)
        return cls(pack_docs(doc_terms, vocab_size, capacity=capacity,
                             device=dev),
                   device=dev, window=window, mesh=mesh,
                   cold_store=cold_store)

    @property
    def index(self) -> PackedIndex:
        return self._index

    @property
    def vocab_size(self) -> int:
        return self._index.vocab_size

    @property
    def n_docs(self) -> int:
        return self._index.n_docs

    @property
    def live_docs(self) -> int:
        return sum(len(b) for b in self._blocks)

    @property
    def n_blocks(self) -> int:
        return len(self._blocks)

    def live_slots(self) -> np.ndarray:
        """Slot ids of all live documents, oldest block first."""
        if not self._blocks:
            return np.zeros((0,), np.int64)
        return np.concatenate(self._blocks)

    # -- scopes -------------------------------------------------------------

    def _scope_host(self, name: str) -> np.ndarray:
        """Host bitmap of ``name``, padded to the current word count."""
        m = self._scopes[name]
        w = self._index.n_words
        if len(m) < w:
            m = np.pad(m, (0, w - len(m)))
            self._scopes[name] = m
        return m

    def tag_scope(self, name: str, doc_slots) -> None:
        """OR ``doc_slots`` into the named scope (created empty)."""
        if name not in self._scopes:
            self._scopes[name] = np.zeros((self._index.n_words,), np.uint32)
        self._scopes[name] = (self._scope_host(name)
                              | slots_bitmap(doc_slots, self._index.n_words))
        self._scope_dev.pop(name, None)
        self._scope_ver[name] = self._scope_ver.get(name, 0) + 1

    def define_scope(self, name: str, doc_slots) -> None:
        """Set the named scope to exactly ``doc_slots`` (a no-op when the
        membership is unchanged, so the device copy stays warm)."""
        new = slots_bitmap(doc_slots, self._index.n_words)
        old = self._scopes.get(name)
        if old is not None and len(old) == len(new) and (old == new).all():
            return
        self._scopes[name] = new
        self._scope_dev.pop(name, None)
        self._scope_ver[name] = self._scope_ver.get(name, 0) + 1

    def drop_scope(self, name: str) -> None:
        self._scopes.pop(name, None)
        self._scope_dev.pop(name, None)
        if name in self._scope_ver:
            self._scope_ver[name] += 1

    def scope_version(self, name: str) -> int:
        """Redefinition counter of ``name`` (0 if never touched)."""
        return self._scope_ver.get(name, 0)

    def scope_names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._scopes))

    def full_mask(self) -> torch.Tensor:
        """All-ones ``(W,)`` bitmap (every word -1): the unscoped scope
        operand, the identity under AND.  Cached per word count."""
        w = self._index.n_words
        if self._full_mask is None or self._full_mask.shape[0] != w:
            self._full_mask = torch.full((w,), -1, dtype=torch.int32,
                                         device=self.device)
        return self._full_mask

    def scope(self, name: str) -> torch.Tensor:
        """Device bitmap of the named scope, cached per epoch."""
        if name not in self._scopes:
            raise KeyError(f"unknown scope {name!r}; "
                           f"defined scopes: {list(self.scope_names())}")
        ent = self._scope_dev.get(name)
        if ent is None or ent[0] != self.epoch:
            ent = (self.epoch, from_uint32(self._scope_host(name), self.device))
            self._scope_dev[name] = ent
        return ent[1]

    # -- cached artifacts ---------------------------------------------------

    def _artifact(self, name: str, build):
        ent = self._cache.get(name)
        if ent is None or ent[0] != self.epoch:
            ent = (self.epoch, build())
            self._cache[name] = ent
        return ent[1]

    def x_dense(self) -> torch.Tensor:
        """Dense int8 incidence X (capacity, V_pad), V padded to a
        multiple of 8, unpacked once per epoch (``dense_operand``): the
        ``.t()`` view of (V_pad, capacity) storage, doc axis contiguous."""
        def build():
            self.unpack_count += 1
            return dense_operand(self._index)
        return self._artifact("x_dense", build)

    def packed_t(self) -> torch.Tensor:
        """Transposed postings (V, W), cached per epoch."""
        return self._artifact("packed_t",
                              lambda: self._index.packed.T.contiguous())

    def packed_t_pad(self) -> torch.Tensor:
        """Transposed postings pre-padded as the reference's fused level
        step takes them — (V_pad, W_pad) with V to a multiple of 8 and W
        to 128, zero bits in the padding — built once per epoch; here the
        mask rows of :func:`~repro_torch.core.materialize.materialize`."""
        return self._artifact("packed_t_pad",
                              lambda: pad_transposed(self._index.packed))

    def cached_artifact(self, key: Tuple, version: int = 0):
        """Epoch- and version-checked lookup (None on a miss)."""
        ent = self._artifact_cache.get(key)
        if ent is not None and ent[0] == self.epoch and ent[1] == version:
            return ent[2]
        return None

    def store_artifact(self, key: Tuple, value, version: int = 0) -> None:
        """Store ``value`` at the current epoch, pruning stale entries."""
        if any(e[0] != self.epoch for e in self._artifact_cache.values()):
            self._artifact_cache = {k: e for k, e in
                                    self._artifact_cache.items()
                                    if e[0] == self.epoch}
        self._artifact_cache[key] = (self.epoch, version, value)

    def operands(self, method: str) -> dict:
        """The artifacts ``method`` needs, from this context's caches."""
        return {name: getattr(self, name)()
                for name in get_count_method(method).needs}

    # -- ingest path --------------------------------------------------------

    def ingest(self, new_doc_terms, new_doc_valid, *,
               on_overflow: str = "raise",
               scope: Union[str, Sequence[str], None] = None) -> np.ndarray:
        """Append a block of documents; returns the slot ids of its valid
        rows.  The capacity check runs on the host BEFORE the scatter
        (which would drop docs past capacity): ``on_overflow="raise"``
        raises CapacityError, ``"grow"`` doubles the capacity until the
        block fits.  ``scope`` tags the new block."""
        valid_np = np.asarray(torch.as_tensor(new_doc_valid).cpu()).astype(bool)
        n_new = int(valid_np.sum())
        needed = self.n_docs + n_new
        if needed > self._index.capacity:
            if on_overflow == "grow":
                self._index = grow_capacity(self._index, needed)
            else:
                raise CapacityError(
                    f"ingest of {n_new} docs would exceed capacity "
                    f"{self._index.capacity} (n_docs={self.n_docs}); "
                    f"pass on_overflow='grow' to repack")
        start = self.n_docs
        slots = np.arange(start, start + n_new, dtype=np.int64)
        row_slots = np.zeros((valid_np.shape[0],), np.int64)
        row_slots[np.flatnonzero(valid_np)] = slots
        self._index = ingest_at(self._index, new_doc_terms,
                                torch.from_numpy(valid_np),
                                torch.from_numpy(row_slots))
        if n_new > 0:
            self._blocks.append(slots)
            if scope is not None:
                for name in ((scope,) if isinstance(scope, str)
                             else tuple(scope)):
                    self.tag_scope(name, slots)
        self.epoch += 1
        return slots

    def grow_vocab(self, min_vocab: int) -> None:
        """Widen the term axis to at least ``min_vocab`` (doubling)."""
        new = grow_vocab(self._index, min_vocab)
        if new is not self._index:
            self._index = new
            self.epoch += 1

    def shrink_vocab(self, vocab_size: int) -> None:
        """Roll back a :meth:`grow_vocab` whose batch never indexed; refuses
        when a dropped column holds postings."""
        v = int(vocab_size)
        if v >= self._index.vocab_size:
            return
        if v < 1:
            raise ValueError(f"vocab_size must be >= 1, got {v}")
        tail_df = self._index.doc_freq[v:].cpu().numpy()
        if tail_df.any():
            raise ValueError(
                f"cannot shrink vocab to {v}: "
                f"{int((tail_df > 0).sum())} dropped column(s) hold postings")
        self._index = PackedIndex(self._index.packed[:, :v].contiguous(),
                                  self._index.doc_freq[:v].clone(),
                                  self._index.n_docs)
        self.epoch += 1

    def ingest_docs(self, doc_terms: Sequence[Sequence[int]], *,
                    max_len: int = 64, on_overflow: str = "raise",
                    on_long: str = "raise", window: Optional[int] = None,
                    scope: Union[str, Sequence[str], None] = None
                    ) -> np.ndarray:
        """Pad token lists to (N, max_len) and ingest; returns the new
        docs' slot ids.  ``on_long="raise"`` refuses documents longer than
        ``max_len`` (truncation would drop postings); ``"truncate"`` keeps
        the first ``max_len`` ids."""
        if window is not None:
            raise not_ported("the sliding window (window=)")
        doc_terms = [list(t) for t in doc_terms]
        over = [(i, len(t)) for i, t in enumerate(doc_terms)
                if len(t) > max_len]
        if over and on_long != "truncate":
            i0, l0 = over[0]
            raise ValueError(
                f"{len(over)} document(s) exceed max_len={max_len} (first: "
                f"doc {i0} with {l0} terms); term ids past max_len would be "
                f"silently dropped — raise max_len or pass on_long='truncate'")
        n = len(doc_terms)
        ids = np.full((n, max_len), -1, np.int32)
        for i, t in enumerate(doc_terms):
            t = t[:max_len]
            ids[i, :len(t)] = t
        return self.ingest(torch.from_numpy(ids),
                           torch.ones((n,), dtype=torch.bool),
                           on_overflow=on_overflow, scope=scope)


def context_from_state(arrays: Dict[str, np.ndarray], meta: dict, *,
                       device="cuda") -> QueryContext:
    """A port context equivalent to the reference context serialised by
    ``repro.core.snapshot.context_state``: ``arrays`` holds ``packed``
    (uint32), ``doc_freq``, ``block_NNNN`` and ``scope_NNNN``; ``meta``
    holds ``n_docs``, ``epoch``, ``scopes`` and ``n_blocks``.  The uint32
    bitmaps are viewed as int32.  The window, cold tier and sketch state
    are not ported; a state that uses them raises."""
    if meta.get("window") is not None:
        raise not_ported("the sliding window (window=)")
    if meta.get("cold_keys"):
        raise not_ported("the cold tier (cold_store=)")
    dev = resolve_device(device)
    index = PackedIndex(
        from_uint32(arrays["packed"], dev),
        torch.from_numpy(np.array(arrays["doc_freq"], np.int32)).to(dev),
        int(meta["n_docs"]))
    ctx = QueryContext(index, device=dev)
    ctx._blocks = [np.asarray(arrays[f"block_{i:04d}"], np.int64)
                   for i in range(int(meta["n_blocks"]))]
    ctx.epoch = int(meta["epoch"])
    ctx._scopes = {name: np.ascontiguousarray(arrays[f"scope_{i:04d}"],
                                              np.uint32)
                   for i, name in enumerate(meta["scopes"])}
    ctx._scope_ver = {k: int(v) for k, v in meta.get("scope_ver", {}).items()}
    return ctx
