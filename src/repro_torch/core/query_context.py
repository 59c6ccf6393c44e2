"""QueryContext — the packed index plus its epoch-versioned artifacts.

Mirrors ``repro.core.query_context`` on one device: the context owns the
packed index and builds its derived artifacts lazily, once per ingest
epoch —

* ``x_dense()``      the dense int8 incidence (the gemm method's and the
  co-occurrence kernel's operand), stored term-major and built in term
  chunks; ``unpack_count`` counts its builds;
* ``forward_index()`` the doc -> terms CSR of the postings, from which
  the exact ``"pallas"`` sweep stages each row group's operands;
* ``packed_t()``     the transposed postings (V, W);
* ``packed_t_pad()`` the transposed postings padded to V % 8 == 0 and
  W % 128 == 0 (the reference's fused level-step operand; here the mask
  rows of materialization), padded once per epoch;
* ``term_signatures()`` the per-term MinHash signatures of the approximate
  sweep (:mod:`repro_torch.core.sketch`), hashed one ingest block at a
  time and min-merged;

plus named document scopes (``(W,)`` bitmaps ANDed into the seed filters),
the all-ones ``full_mask`` (the unscoped scope operand), a generic
epoch-checked artifact cache, and ingest with a host-side capacity check.
:mod:`repro_torch.core.snapshot` saves and restores the whole state.

**Sliding window.**  With ``window=N`` the context stops growing and
manages doc slots as a ring: each ingest batch is a block of consecutive
ring slots, and when live docs would exceed the window the oldest blocks
are evicted (their postings bits cleared and their ``doc_freq``
contributions decremented by :func:`~repro_torch.core.inverted_index.
retire_docs`) before the new block is scattered into the freed slots.
Capacity is pinned at ``ceil(window / 32) * 32`` slots.  Liveness is host
bookkeeping (the block deque), never a device search.

**Cold tier.**  With ``cold_store=`` (a ``MutableMapping[str, bytes]``,
:mod:`repro_torch.core.storage`) every evicted block is first re-packed on
the device from the word rows it touches and spilled as a self-contained
payload, the reference's format; :meth:`QueryContext.all_time_index`
stacks the cold blocks under the live bitmap.

While a profile records, the ingest path's phases are spans of
:mod:`repro_torch.tracing`: ``cooc.ingest.lists`` (token lists padded
into a block), ``cooc.ingest.retire`` (an eviction, its spill included),
``cooc.spill.encode`` (the payload copied to the host and encoded),
``cooc.spill.write`` (the store's write) and ``cooc.ingest.scatter``.

**Mesh.**  With ``mesh=`` (:func:`~repro_torch.core.distributed.
make_cooc_mesh`) the context lives on the mesh's first device and every
query path runs sharded across the mesh (:mod:`repro_torch.core.
distributed`), bit-identical to the single-device path.  The per-shard
operands are one more epoch artifact (:meth:`QueryContext.mesh_shards`).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.inverted_index import (
    ForwardIndex,
    PackedIndex,
    dense_operand,
    forward_index,
    from_uint32,
    grow_capacity,
    grow_vocab,
    ingest_at,
    pack_docs,
    retire_docs,
    slots_bitmap,
    to_uint32,
)
from repro_torch.core.query import count_method_names, get_count_method
from repro_torch.core.storage import ColdBlock, decode_block, encode_block
from repro_torch.kernels.ref import popcount32
from repro_torch.device import canonical_device, resolve_device


class _CountMethodsView(Mapping):
    """Deprecated read-only alias over the count-method registry: the
    legacy ``COUNT_METHODS`` mapping of method name to ``needs``, live as
    methods are registered.  The registry (:mod:`repro_torch.core.query`)
    is the one source of truth."""

    def __getitem__(self, name):
        try:
            return get_count_method(name).needs
        except ValueError as e:           # Mapping protocol wants KeyError
            raise KeyError(name) from e

    def __iter__(self):
        return iter(count_method_names())

    def __len__(self):
        return len(count_method_names())


#: Deprecated: use repro_torch.core.query.get_count_method.
COUNT_METHODS = _CountMethodsView()


class CapacityError(ValueError):
    """Ingest would overflow the packed index's doc capacity."""


def pad_transposed(packed: torch.Tensor) -> torch.Tensor:
    """(W, V) postings -> (V_pad, W_pad) transposed, V padded to a multiple
    of 8 and W to a multiple of 128 with zero bits."""
    w, v = packed.shape
    out = packed.new_zeros((v + (-v) % 8, w + (-w) % 128))
    out[:v, :w] = packed.T
    return out


class QueryContext:
    """Packed index + epoch-versioned caches, on one device or on the
    first device of a mesh."""

    def __init__(self, index: PackedIndex, *, device="cuda",
                 window: Optional[int] = None, mesh=None, cold_store=None):
        self.device = resolve_device(device)
        if mesh is not None:
            from repro_torch.core.distributed import mesh_device
            first = mesh_device(mesh)
            if canonical_device(self.device) != first:
                raise ValueError(
                    f"device={self.device} but the mesh's first device is "
                    f"{first}: a meshed context lives there (pass "
                    f"device={str(first)!r})")
            self.device = first
        self._mesh = mesh
        self._index = PackedIndex(index.packed.to(self.device),
                                  index.doc_freq.to(self.device),
                                  int(index.n_docs))
        # cold tier: every evicted block is spilled to this store before
        # its postings bits are cleared
        self._cold = cold_store
        self._cold_seq = 0        # next spill key / cold-tier version
        self.epoch = 0
        self.unpack_count = 0   # monitoring: dense rebuilds == ingest epochs
        self._cache: Dict[object, Tuple[int, object]] = {}
        # generic epoch-versioned artifact cache: key -> (epoch, version, value)
        self._artifact_cache: Dict[Tuple, Tuple[int, int, object]] = {}
        self._scope_ver: Dict[str, int] = {}
        # streaming state: live ingest blocks (slot arrays, oldest first)
        # and the ring write head
        n0 = self._index.n_docs
        self._blocks: Deque[np.ndarray] = deque()
        if n0 > 0:
            self._blocks.append(np.arange(n0, dtype=np.int64))
        self._ring_tail = n0
        self._window: Optional[int] = None
        # blocks live before a set_window capacity growth may sit anywhere
        # in the padded ring; only the oldest _stranded blocks can overlap
        # a fresh target range, so steady-state ingest skips the sweep
        self._stranded = 0
        self._scopes: Dict[str, np.ndarray] = {}
        self._scope_dev: Dict[str, Tuple[int, torch.Tensor]] = {}
        self._full_mask: Optional[torch.Tensor] = None
        self.evicted_docs_total = 0    # monitoring: docs retired by the ring
        # MinHash sketch state (core.sketch): per (num_perm, seed), the
        # live blocks' signatures as (block_array, sig) pairs matched by
        # identity, so term_signatures hashes only blocks it has not seen
        # (a live block's postings bits never change)
        self._sketch_blocks: Dict[Tuple[int, int], list] = {}
        # the reference's dense dtype, carried through snapshots; the
        # port's x_dense is int8 whatever it names
        self._dtype = "bfloat16"
        if window is not None:
            if n0 > int(window):
                raise ValueError(
                    f"initial corpus of {n0} docs exceeds window={window}; "
                    "it could never be live in full — raise the window or "
                    "pre-trim the corpus")
            self.set_window(window)

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
    def mesh(self):
        """The context's query mesh (None = single-device execution)."""
        return self._mesh

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
        return np.concatenate(list(self._blocks))

    # -- streaming window ---------------------------------------------------

    @property
    def window(self) -> Optional[int]:
        return self._window

    def set_window(self, window: int) -> None:
        """Enter (or resize) sliding-window mode: at most ``window`` live
        docs, capacity pinned at ``ceil(window/32)*32`` slots.  Shrinking
        below the current live count evicts oldest blocks to fit."""
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        need_words = (window + 31) // 32
        if need_words > self._index.n_words:
            packed = self._index.packed.new_zeros(
                (need_words, self._index.vocab_size))
            packed[:self._index.n_words] = self._index.packed
            self._index = PackedIndex(packed, self._index.doc_freq,
                                      self._index.n_docs)
            self.epoch += 1          # X's doc axis grew: rebuild once
            if self._blocks:
                self._stranded = len(self._blocks)
        self._window = window
        if self._evict_for(0):
            self.epoch += 1          # retired docs: caches must rebuild

    def _evict_for(self, n_new: int) -> int:
        """Evict oldest blocks until ``live + n_new <= window``; one retire
        pass for all of them.  Returns #docs evicted."""
        evicted: list = []
        while self._blocks and self.live_docs + n_new > self._window:
            evicted.append(self._blocks.popleft())
            self._stranded = max(0, self._stranded - 1)
        if not evicted:
            return 0
        slots = np.concatenate(evicted)
        self._retire_slots(slots)
        return len(slots)

    def _retire_slots(self, slots: np.ndarray) -> None:
        """Spill ``slots`` to the cold store (if any) while their bits are
        still set, then clear them from the index and from every scope."""
        with tracing.span("cooc.ingest.retire"):
            if self._cold is not None and len(slots):
                self._spill_block(np.asarray(slots, np.int64))
            mask = slots_bitmap(slots, self._index.n_words)
            self._index = retire_docs(self._index, mask)
            for name in self._scopes:
                self._scopes[name] = self._scope_host(name) & ~mask
                self._scope_dev.pop(name, None)
            self.evicted_docs_total += len(slots)

    def retire_oldest_block(self) -> int:
        """Evict the oldest ingest block by hand.  Returns #docs retired;
        bumps the epoch iff anything was retired."""
        if not self._blocks:
            return 0
        slots = self._blocks.popleft()
        self._stranded = max(0, self._stranded - 1)
        self._retire_slots(slots)
        self.epoch += 1
        return len(slots)

    # -- cold tier ----------------------------------------------------------

    @property
    def cold_store(self):
        """The attached cold-tier store (a MutableMapping[str, bytes]), or
        None: then evicted blocks are destroyed."""
        return self._cold

    def cold_version(self) -> int:
        """Spill counter: bumps once per spilled block, so artifacts
        derived from the cold tier version on it."""
        return self._cold_seq

    def cold_blocks(self) -> int:
        return len(self._cold) if self._cold is not None else 0

    def _spill_block(self, slots: np.ndarray) -> None:
        """Write ``slots``' postings to the cold store as a self-contained
        :class:`~repro_torch.core.storage.ColdBlock`: doc ``i`` of the
        block is bit ``i % 32`` of word row ``i // 32``.  The block is
        re-packed on the device from the word rows it touches, one output
        bit position at a time, so no (n, V) intermediate is built; only
        the (ceil(n/32), V) payload crosses to the host."""
        dev = self.device
        n, v = len(slots), self._index.vocab_size
        word = slots // 32
        uw = np.unique(word)
        rows = self._index.packed[torch.from_numpy(uw).to(dev)]
        pos = torch.from_numpy(np.searchsorted(uw, word)).to(dev)
        shift = torch.from_numpy((slots % 32).astype(np.int32)).to(dev)
        packed = rows.new_zeros(((n + 31) // 32, v))
        for b in range(min(32, n)):
            src, sh = pos[b::32], shift[b::32]
            weight = (1 << b) - (1 << 32 if b == 31 else 0)  # int32 pattern
            packed[:len(src)] |= ((rows[src] >> sh[:, None]) & 1) * weight
        df = popcount32(packed).sum(dim=0, dtype=torch.int32)
        key = f"block-{self._cold_seq:08d}"
        with tracing.span("cooc.spill.encode"):
            payload = encode_block(ColdBlock(
                to_uint32(packed), df.cpu().numpy(), n, v))
        with tracing.span("cooc.spill.write"):
            self._cold[key] = payload
        self._cold_seq += 1

    def all_time_index(self) -> PackedIndex:
        """Live and cold tiers as one bare :class:`PackedIndex`: the cold
        blocks' word rows (in key order) stacked under the live bitmap.
        Counts are additive over disjoint doc sets, so any count method
        over it answers over every doc ever ingested.  The live index
        itself when nothing has spilled."""
        if self._cold is None or len(self._cold) == 0:
            return self._index
        v = self._index.vocab_size
        parts = [self._index.packed]
        df = self._index.doc_freq
        for key in sorted(self._cold):
            blk = decode_block(self._cold[key])
            cw, cdf = blk.packed, blk.doc_freq
            if blk.vocab > v:
                # only an all-zero overhang is droppable (shrink_vocab's
                # contract on the live index)
                if cdf[v:].any():
                    raise ValueError(
                        f"cold block {key} holds postings for terms >= the "
                        f"live vocab {v}; cannot query it under this index")
                cw, cdf = cw[:, :v], cdf[:v]
            elif blk.vocab < v:
                cw = np.pad(cw, ((0, 0), (0, v - blk.vocab)))
                cdf = np.pad(cdf, (0, v - blk.vocab))
            parts.append(from_uint32(cw, self.device))
            df = df + torch.from_numpy(np.ascontiguousarray(cdf, np.int32)
                                       ).to(self.device)
        packed = torch.cat(parts)
        return PackedIndex(packed, df, packed.shape[0] * 32)

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

    def _artifact(self, name, build):
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

    def built_artifact(self, name: str):
        """The epoch artifact ``name`` (``"x_dense"``, ...) if this epoch
        has built it, else None; builds nothing."""
        ent = self._cache.get(name)
        return ent[1] if ent is not None and ent[0] == self.epoch else None

    def forward_index(self) -> ForwardIndex:
        """The doc -> terms CSR of the postings (:func:`~repro_torch.core.
        inverted_index.forward_index`), built once per epoch: the
        compacted operands of the exact ``"pallas"`` sweep are staged from
        it."""
        return self._artifact("forward_index",
                              lambda: forward_index(self._index))

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

    def term_signatures(self, *, num_perm: int = 128,
                        seed: int = 0) -> torch.Tensor:
        """Per-term MinHash signatures (V, num_perm), int32 uint32 patterns,
        over the live postings (:mod:`repro_torch.core.sketch`), cached per
        epoch through :meth:`cached_artifact`.  Under a mesh they are
        computed sharded alongside the postings
        (:func:`repro_torch.core.distributed.sharded_signatures`).

        The rebuild is incremental: each live ingest block is hashed once
        (keyed on block identity: a live block's bits never change) and
        the served signature is an unsigned min over the live blocks, so
        an ingest hashes only the new block and an eviction drops the
        evicted block's part.  Vocabulary growth pads old block signatures
        with ``SIG_EMPTY``; a shrink slices them."""
        from repro_torch.core import sketch
        cfg = (int(num_perm), int(seed))
        key = ("minhash",) + cfg
        hit = self.cached_artifact(key, version=0)
        if hit is not None:
            return hit
        v = self.vocab_size
        a, b = sketch.hash_coefficients(num_perm, seed)
        if self._mesh is not None:
            from repro_torch.core.distributed import sharded_signatures
            sig = sharded_signatures(self._index.packed, a, b, self._mesh)
            self.store_artifact(key, sig)
            return sig
        prev = {id(e[0]): e for e in self._sketch_blocks.get(cfg, [])}
        ents = []
        for blk in self._blocks:
            ent = prev.get(id(blk))
            if ent is None or ent[0] is not blk:
                ent = (blk, sketch.block_signatures(self._index.packed, blk,
                                                    a, b))
            elif ent[1].shape[0] != v:
                sig_b = ent[1]
                if sig_b.shape[0] > v:
                    sig_b = sig_b[:v]
                else:
                    sig_b = torch.cat([sig_b, sig_b.new_full(
                        (v - sig_b.shape[0], sig_b.shape[1]), -1)])
                ent = (blk, sig_b)
            ents.append(ent)
        self._sketch_blocks[cfg] = ents
        sig = sketch.merge_signatures([e[1] for e in ents], v, int(num_perm),
                                      device=self.device)
        self.store_artifact(key, sig)
        return sig

    def mesh_shards(self, mesh=None):
        """The per-shard operands of the live index over ``mesh``
        (default: the context's own), a :class:`~repro_torch.core.
        distributed.ShardedIndex` built once per epoch: an ingest,
        eviction or vocabulary growth rebuilds it, a query never does.
        Only the current epoch's shards are kept."""
        from repro_torch.core.distributed import ShardedIndex
        mesh = self._mesh if mesh is None else mesh
        if mesh is None:
            raise ValueError("mesh_shards needs a mesh: the context has none")
        name = ("shards",) + mesh.key
        for key in [k for k, e in self._cache.items()
                    if isinstance(k, tuple) and e[0] != self.epoch]:
            del self._cache[key]
        return self._artifact(name, lambda: ShardedIndex(self._index, mesh))

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
        """Ingest a block of documents; returns the slot ids of its valid
        rows (in row order).

        Append mode: the capacity check runs on the host BEFORE the
        scatter (which would drop docs past capacity):
        ``on_overflow="raise"`` raises CapacityError, ``"grow"`` doubles
        the capacity until the block fits.

        Window mode: the oldest blocks are evicted until the block fits
        under ``window``, then it is scattered into ring slots
        ``(tail + i) % capacity``; capacity never grows, and a block larger
        than the window is refused.  ``scope`` tags the new block."""
        valid_np = np.asarray(torch.as_tensor(new_doc_valid).cpu()).astype(bool)
        n_new = int(valid_np.sum())
        if self._window is not None:
            if n_new > self._window:
                raise ValueError(
                    f"ingest block of {n_new} docs exceeds window="
                    f"{self._window}; it could never be live in full — "
                    "split the block or raise the window")
            self._evict_for(n_new)
            cap = self._index.capacity
            slots = (self._ring_tail + np.arange(n_new, dtype=np.int64)) % cap
            # ingest_at needs all-zero target slots.  The eviction above
            # guarantees that while the live region is circular-contiguous,
            # but a set_window growth can leave wrapped live blocks
            # stranded anywhere in the ring: evict (oldest first) until
            # none overlaps the target range
            stranded = []
            while self._stranded and any(
                    np.isin(b, slots).any()
                    for b in list(self._blocks)[:self._stranded]):
                stranded.append(self._blocks.popleft())
                self._stranded -= 1
            if stranded:
                self._retire_slots(np.concatenate(stranded))
            self._ring_tail = int((self._ring_tail + n_new) % cap)
        else:
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
            self._ring_tail = start + n_new
        row_slots = np.zeros((valid_np.shape[0],), np.int64)
        row_slots[np.flatnonzero(valid_np)] = slots
        with tracing.span("cooc.ingest.scatter"):
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
        the first ``max_len`` ids.  ``window`` enters (or resizes)
        sliding-window mode first, as :meth:`set_window` does."""
        if window is not None:
            self.set_window(window)
        with tracing.span("cooc.ingest.lists"):
            doc_terms = [list(t) for t in doc_terms]
            over = [(i, len(t)) for i, t in enumerate(doc_terms)
                    if len(t) > max_len]
            if over and on_long != "truncate":
                i0, l0 = over[0]
                raise ValueError(
                    f"{len(over)} document(s) exceed max_len={max_len} "
                    f"(first: doc {i0} with {l0} terms); term ids past "
                    f"max_len would be silently dropped — raise max_len or "
                    f"pass on_long='truncate'")
            n = len(doc_terms)
            ids = np.full((n, max_len), -1, np.int32)
            for i, t in enumerate(doc_terms):
                t = t[:max_len]
                ids[i, :len(t)] = t
        return self.ingest(torch.from_numpy(ids),
                           torch.ones((n,), dtype=torch.bool),
                           on_overflow=on_overflow, scope=scope)



# the restore lives with the snapshot format; re-exported for its callers
from repro_torch.core.snapshot import context_from_state  # noqa: E402,F401
