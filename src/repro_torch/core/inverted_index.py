"""The bit-packed inverted index, in PyTorch.

Mirrors ``repro.core.inverted_index``: ``packed`` is a ``(W, V)`` bitmap
with ``W = ceil(capacity / 32)``; bit ``d % 32`` of ``packed[d // 32, v]``
is set iff document ``d`` contains term ``v``, so column ``v`` is the
postings list of term ``v``, a filter (AND of terms) is a bitwise AND of
columns, and document frequency under a filter is a popcount.

Bitmaps are int32 tensors holding the uint32 bit patterns of the reference
(torch's uint32 has no ``>>`` on the CPU): :func:`from_uint32` and
:func:`to_uint32` convert at the numpy boundary, bit for bit.  The all-ones
word ``0xFFFFFFFF`` is ``-1``.

The lexicon (term string <-> id) lives on the host; the device never sees
strings.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ref import popcount32, postings_counts_ref


class PackedIndex(NamedTuple):
    """Device-side inverted index (bit-packed doc-term incidence)."""

    packed: torch.Tensor     # (W, V) int32 bit patterns of the postings
    doc_freq: torch.Tensor   # (V,) int32 global document frequency per term
    n_docs: int              # valid-slot high-water mark

    @property
    def n_words(self) -> int:
        return self.packed.shape[0]

    @property
    def vocab_size(self) -> int:
        return self.packed.shape[1]

    @property
    def capacity(self) -> int:
        """Max docs this packed buffer can hold."""
        return self.n_words * 32

    @property
    def device(self) -> torch.device:
        return self.packed.device


@dataclasses.dataclass
class Lexicon:
    """Host-side term dictionary (the paper's lexicon component)."""

    term_to_id: Dict[str, int] = dataclasses.field(default_factory=dict)
    id_to_term: List[str] = dataclasses.field(default_factory=list)

    def add(self, term: str) -> int:
        tid = self.term_to_id.get(term)
        if tid is None:
            tid = len(self.id_to_term)
            self.term_to_id[term] = tid
            self.id_to_term.append(term)
        return tid

    def __len__(self) -> int:
        return len(self.id_to_term)

    def lookup(self, term: str) -> int:
        return self.term_to_id[term]


# ---------------------------------------------------------------------------
# numpy boundary
# ---------------------------------------------------------------------------


def from_uint32(a, device) -> torch.Tensor:
    """uint32 numpy bitmap -> int32 tensor with the same bit patterns."""
    a = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def to_uint32(t: torch.Tensor) -> np.ndarray:
    """int32 bitmap tensor -> uint32 numpy array with the same bits."""
    return t.detach().cpu().numpy().astype(np.int32, copy=False).view(np.uint32)


# ---------------------------------------------------------------------------
# Host-side construction
# ---------------------------------------------------------------------------


def pack_docs(doc_terms: Sequence[Sequence[int]], vocab_size: int,
              capacity: Optional[int] = None, *,
              device="cuda") -> PackedIndex:
    """Build a PackedIndex from tokenised documents (lists of term ids),
    bit-identical to ``repro.core.inverted_index.pack_docs``.  Term ids
    outside [0, vocab_size) are ignored; repeats within a doc count once."""
    dev = resolve_device(device)
    n_docs = len(doc_terms)
    cap = max(capacity if capacity is not None else n_docs, n_docs)
    n_words = (cap + 31) // 32
    lens = np.fromiter((len(t) for t in doc_terms), np.int64, count=n_docs)
    flat = np.fromiter(itertools.chain.from_iterable(doc_terms), np.int64,
                       count=int(lens.sum()))
    docs = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
    ok = (flat >= 0) & (flat < vocab_size)
    key = np.unique(docs[ok] * vocab_size + flat[ok])
    d, t = key // vocab_size, key % vocab_size
    packed = np.zeros((n_words, vocab_size), np.uint32)
    np.bitwise_or.at(packed, (d // 32, t),
                     np.left_shift(np.uint32(1), (d % 32).astype(np.uint32)))
    df = np.bincount(t, minlength=vocab_size).astype(np.int32)
    return PackedIndex(from_uint32(packed, dev), torch.from_numpy(df).to(dev),
                       n_docs)


def grow_capacity(index: PackedIndex, min_capacity: int) -> PackedIndex:
    """Repack to a larger doc capacity (at least ``min_capacity``),
    doubling until it fits.  Only all-zero word rows are added."""
    if min_capacity <= index.capacity:
        return index
    cap = max(index.capacity, 32)
    while cap < min_capacity:
        cap *= 2
    packed = index.packed.new_zeros(((cap + 31) // 32, index.vocab_size))
    packed[:index.n_words] = index.packed
    return PackedIndex(packed, index.doc_freq, index.n_docs)


def grow_vocab(index: PackedIndex, min_vocab: int) -> PackedIndex:
    """Repack to a larger vocabulary (at least ``min_vocab`` term columns),
    doubling until it fits.  New columns are all-zero postings."""
    if min_vocab <= index.vocab_size:
        return index
    v = max(index.vocab_size, 1)
    while v < min_vocab:
        v *= 2
    packed = index.packed.new_zeros((index.n_words, v))
    packed[:, :index.vocab_size] = index.packed
    df = index.doc_freq.new_zeros((v,))
    df[:index.vocab_size] = index.doc_freq
    return PackedIndex(packed, df, index.n_docs)


def _bits(words: torch.Tensor, axis: int) -> torch.Tensor:
    """0/1 int32 bits of every word, bit index inserted at ``axis``."""
    shape = [1] * (words.dim() + 1)
    shape[axis] = 32
    shifts = torch.arange(32, dtype=torch.int32,
                          device=words.device).reshape(shape)
    return (words.unsqueeze(axis) >> shifts) & 1


#: terms unpacked per step of a dense incidence build: the step's int32
#: bit intermediate is chunk x capacity x 4 bytes (1.6 GB at the CSL scale)
DENSE_CHUNK_TERMS = 1024


def _incidence_terms(index: PackedIndex, dtype, pad_to: int) -> torch.Tensor:
    """The dense 0/1 incidence, term-major: (V_pad, capacity) with V padded
    to a multiple of ``pad_to`` by zero rows, so each term's docs are
    contiguous.  Unpacked ``DENSE_CHUNK_TERMS`` terms at a time from the
    transposed postings, so no intermediate is larger than one chunk's
    bits (never the (W, 32, V) int32 whole)."""
    v, w = index.vocab_size, index.n_words
    rows = index.packed.T
    out = torch.zeros((v + (-v) % pad_to, w * 32), dtype=dtype,
                      device=index.device)
    for v0 in range(0, v, DENSE_CHUNK_TERMS):
        v1 = min(v0 + DENSE_CHUNK_TERMS, v)
        out[v0:v1] = unpack_bitmap(rows[v0:v1], dtype)
    return out


def incidence_dense(index: PackedIndex, dtype=torch.float32) -> torch.Tensor:
    """Unpack to the dense incidence matrix X (capacity, V): the ``.t()``
    view of term-major storage, built in term chunks."""
    return _incidence_terms(index, dtype, 1).t()


# ---------------------------------------------------------------------------
# Index algebra
# ---------------------------------------------------------------------------


def empty_mask(index: PackedIndex) -> torch.Tensor:
    """All-docs bitmap (the unconstrained filter), masked to n_docs."""
    word = torch.arange(index.n_words, dtype=torch.int64, device=index.device)
    nbits = (index.n_docs - word * 32).clamp(0, 32)
    m = (torch.ones_like(nbits) << nbits) - 1          # int64: exact at 32
    return torch.where(m >= 2 ** 31, m - 2 ** 32, m).to(torch.int32)


def term_postings(index: PackedIndex, term_id) -> torch.Tensor:
    """Postings bitmap of one term: column ``term_id`` of ``packed``,
    (W,) int32 bit patterns.  An id out of range is read as the
    reference's ``dynamic_index_in_dim`` reads it: one in [-V, 0) counts
    from the end, and any other is clamped to [0, V - 1]."""
    v = index.vocab_size
    t = int(term_id)
    t = t + v if t < 0 else t
    return index.packed[:, min(max(t, 0), v - 1)]


def and_term(index: PackedIndex, mask: torch.Tensor,
             term_id) -> torch.Tensor:
    """Add a term to the filter conditions (paper: 'add word to retrieval
    conditions') = AND its postings into the filter bitmap."""
    return mask & term_postings(index, term_id)


def mask_count(mask: torch.Tensor) -> torch.Tensor:
    """Number of documents matching a filter bitmap (an int32 scalar)."""
    return popcount32(mask).sum(dtype=torch.int32)


def doc_freq_under(index: PackedIndex, mask: torch.Tensor) -> torch.Tensor:
    """Document frequency of every term within the filtered doc set:
    ``f[v] = sum_w popcount(mask[w] & packed[w, v])``, (V,) int32 — the
    single-filter case of :func:`doc_freq_under_batch`."""
    return postings_counts_ref(mask[None, :], index.packed)[0]


def doc_freq_under_batch(index: PackedIndex,
                         masks: torch.Tensor) -> torch.Tensor:
    """masks (B, W) -> counts (B, V): every frontier filter against the
    whole index, as plain AND + popcount tensor code.  This is the served
    ``"popcount"`` method on every device, so the plain postings version
    in ``kernels/ref.py`` is production code as well as the kernel's
    yardstick."""
    return postings_counts_ref(masks, index.packed)


def unpack_bitmap(masks: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Filter bitmaps (B, W) -> dense 0/1 (B, W*32)."""
    b, w = masks.shape
    return _bits(masks, 2).reshape(b, w * 32).to(dtype)


class ForwardIndex(NamedTuple):
    """The index turned around: doc -> terms in CSR form.  The terms of
    doc ``d`` are ``terms[ptr[d]:ptr[d + 1]]``, ascending; ``ptr`` has
    one entry per doc slot of the capacity, plus one."""

    ptr: torch.Tensor        # (capacity + 1,) int64
    terms: torch.Tensor      # (nnz,) int32, doc-major

    @property
    def nnz(self) -> int:
        return self.terms.shape[0]


#: word rows of the postings expanded per step of a forward index build:
#: the step's intermediates are a few bytes per (doc, term) pair of the
#: rows' documents
FORWARD_CHUNK_WORDS = 2048


def forward_index(index: PackedIndex) -> ForwardIndex:
    """The (doc, term) pairs of ``index`` as a :class:`ForwardIndex`.
    Each step expands the nonzero words of ``FORWARD_CHUNK_WORDS`` word
    rows into their set bits, so no intermediate holds more than those
    rows' pairs; one sort on an int64 (doc, term) key orders them."""
    w, v = index.n_words, index.vocab_size
    shifts = torch.arange(32, dtype=torch.int32, device=index.device)
    keys = [torch.zeros((0,), dtype=torch.int64, device=index.device)]
    for w0 in range(0, w, FORWARD_CHUNK_WORDS):
        blk = index.packed[w0:w0 + FORWARD_CHUNK_WORDS]
        word, term = blk.nonzero(as_tuple=True)
        hit, bit = ((blk[word, term][:, None] >> shifts) & 1).nonzero(
            as_tuple=True)
        keys.append(((w0 + word[hit]) * 32 + bit) * v + term[hit])
    key = torch.sort(torch.cat(keys)).values
    doc = key // v
    counts = torch.zeros((w * 32,), dtype=torch.int64, device=index.device)
    counts.index_add_(0, doc, torch.ones_like(doc))
    ptr = torch.nn.functional.pad(torch.cumsum(counts, 0), (1, 0))
    return ForwardIndex(ptr, (key - doc * v).to(torch.int32))


#: the int8 GEMM on CUDA takes more than 16 rows and a multiple of 8
#: columns in each operand
_INT_MM_MIN_ROWS = 17


def dense_operand(index: PackedIndex) -> torch.Tensor:
    """The dense operand of the gemm method and of the co-occurrence
    kernel: the 0/1 incidence as int8, logical shape (capacity, V_pad)
    with V padded to a multiple of 8 by zero columns.  It is the ``.t()``
    view of term-major (V_pad, capacity) storage, so the doc axis (the
    products' contraction axis) is contiguous.  int8 holds the reference's
    bf16 artifact in half the bytes."""
    return _incidence_terms(index, torch.int8, 8).t()


def doc_freq_under_batch_gemm(masks: torch.Tensor,
                              x_dense: torch.Tensor) -> torch.Tensor:
    """counts = unpack(masks) @ X, (B, D) x (D, V_pad) -> (B, V_pad) int32.

    ``x_dense`` is :func:`dense_operand`, handed to the GEMM as the
    column-major view it is (no copy).  The product accumulates in int32
    (``torch._int_mm``), exact at any D; the rows are padded to the GEMM's
    minimum and sliced off."""
    b = masks.shape[0]
    m = unpack_bitmap(masks, torch.int8)
    m = torch.nn.functional.pad(m, (0, 0, 0, max(0, _INT_MM_MIN_ROWS - b)))
    return torch._int_mm(m, x_dense)[:b]


def slots_bitmap(doc_slots, n_words: int) -> np.ndarray:
    """Host helper: doc slot ids -> (W,) uint32 doc bitmap."""
    m = np.zeros((n_words,), np.uint32)
    s = np.asarray(doc_slots, np.int64).reshape(-1)
    if s.size:
        if s.min() < 0 or s.max() >= n_words * 32:
            raise ValueError(f"doc slot out of range [0, {n_words * 32})")
        np.bitwise_or.at(m, s // 32, np.uint32(1) << (s % 32).astype(np.uint32))
    return m


def retire_docs(index: PackedIndex, doc_mask) -> PackedIndex:
    """Evict a document set: clear its postings bits, decrement doc_freq.

    ``doc_mask`` is the (W,) bitmap of the doc slots to retire
    (:func:`slots_bitmap`), uint32 numpy or an int32 bit-pattern tensor.
    Only the word rows where the mask is nonzero are read and rewritten
    (a block of docs covers a few rows of the bitmap); the result equals
    the reference's full AND pass bit for bit.  ``doc_freq`` drops by the
    popcount of the cleared bits.  ``n_docs`` stays the valid-slot
    high-water mark.  Returns a new index (the input's tensors are not
    modified)."""
    dev = index.device
    if not isinstance(doc_mask, torch.Tensor):
        doc_mask = from_uint32(doc_mask, dev)
    mask = doc_mask.to(device=dev, dtype=torch.int32)
    rows = torch.nonzero(mask).squeeze(1)
    sub = index.packed[rows]
    m = mask[rows, None]
    packed = index.packed.clone()
    packed[rows] = sub & ~m
    df = index.doc_freq - popcount32(sub & m).sum(dim=0, dtype=torch.int32)
    return PackedIndex(packed, df, index.n_docs)


def ingest(index: PackedIndex, new_doc_terms, new_doc_valid) -> PackedIndex:
    """Real-time ingest: append a block of documents at ``index.n_docs``.

    new_doc_terms: (N, M) term ids padded with -1; new_doc_valid: (N,)
    bool.  Requires capacity headroom."""
    valid = torch.as_tensor(new_doc_valid, device=index.device).to(torch.bool)
    slots = index.n_docs + torch.cumsum(valid.to(torch.int64), 0) - 1
    return ingest_at(index, new_doc_terms, valid, slots)


def ingest_at(index: PackedIndex, new_doc_terms, new_doc_valid,
              doc_slots) -> PackedIndex:
    """Scatter a block of documents into explicit slot positions.

    ``doc_slots`` (N,) names each row's target slot (invalid rows are
    ignored); target slots must hold all-zero postings.  Each distinct
    (doc, term) pair sets one bit and adds one to ``doc_freq``; terms
    outside [0, V) and words past the capacity are dropped as the
    reference's ``mode="drop"`` scatter drops them.  Returns a new index
    (the input's tensors are not modified)."""
    dev = index.device
    terms = torch.as_tensor(new_doc_terms, device=dev).to(torch.int64)
    n_new, m = terms.shape
    if n_new == 0:
        return index
    valid = torch.as_tensor(new_doc_valid, device=dev).to(torch.bool)
    slots = torch.as_tensor(doc_slots, device=dev).to(torch.int64).clamp(min=0)
    v = index.vocab_size
    flat_terms = terms.reshape(-1)
    flat_docs = slots.repeat_interleave(m)
    ok = (flat_terms >= 0) & (flat_terms < v) & valid.repeat_interleave(m)
    # one sort on an int64 (doc, term) key dedupes repeated terms in a doc
    key = torch.unique(flat_docs[ok] * v + flat_terms[ok])
    # the block's int64 expansions (8 bytes a padded slot each) are freed
    # before the bitmap's copy is made beside the original
    del terms, flat_terms, flat_docs, ok
    d, t = key // v, key % v
    word = d // 32
    bit = torch.ones_like(d) << (d % 32)
    bit = torch.where(bit >= 2 ** 31, bit - 2 ** 32, bit).to(torch.int32)
    # disjoint bits into all-zero targets: two's-complement addition is OR
    # (no carries), the argument of the reference's scatter-add
    inw = word < index.n_words
    packed = index.packed.clone()
    packed.view(-1).index_add_(0, (word * v + t)[inw], bit[inw])
    df = index.doc_freq.clone()
    df.index_add_(0, t, torch.ones_like(t, dtype=torch.int32))
    live = slots[valid]
    high_water = int(live.max()) + 1 if live.numel() else 0
    return PackedIndex(packed, df, max(index.n_docs, high_water))
