"""MinHash sketches and LSH banding: the approximate-materialization core.

Mirrors ``repro.core.sketch``.  Exact materialization is quadratic in the
vocabulary; per-term **MinHash signatures** over the postings turn "which
term pairs can have a high Jaccard similarity?" into a bucket lookup, and
exact counting then runs on the candidate pairs only.

* :func:`minhash_signatures` — per-term signatures over a whole packed
  bitmap, on its device.  Permutation ``p`` is the multiply-shift hash
  ``h_p(d) = a_p * d + b_p (mod 2^32)`` of the doc slot id ``d``, ``a_p``
  odd, so each ``h_p`` is a bijection of the 32-bit slot ids and
  ``P[min h_p(A) == min h_p(B)] == J(A, B)``.
* :func:`block_signatures` — the same restricted to one ingest block's
  slots, the incremental unit: block signatures min-merge into the live
  signature (:func:`merge_signatures`) in any order, identical to a
  rebuild.
* :func:`lsh_params`, :func:`candidate_columns`, :func:`pad_candidates`,
  :func:`estimate_recall` — host numpy code, copies of the reference's.
* :func:`gathered_top_k` — top-k over a gathered candidate tile, mapped
  back to global term ids, in ``lax.top_k`` order.

The reference hashes every (slot, term) cell of the bitmap for a chunk of
permutations, a (chunk, D, V) transient.  Here the same function is
computed from the set bits only: the nonzero words of the word rows are
expanded to (slot, term) pairs (one per posting), each pair is hashed for
a chunk of :data:`PERM_CHUNK` permutations in int64, and a
``scatter_reduce(..., "amin")`` folds the hashes into the (V, P) result.

Signatures are int32 tensors holding uint32 bit patterns, as the port's
bitmaps are; :data:`SIG_EMPTY` (2^32 - 1, the pattern -1) fills terms with
no postings.  Every min and compare of signatures is unsigned: the sign
bit is flipped around ``torch.minimum`` (:func:`merge_signatures`).
"""
from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import topk_lower_index

#: signature value of a term with no postings (min over an empty set)
SIG_EMPTY = 0xFFFFFFFF

DEFAULT_NUM_PERM = 128
DEFAULT_THRESHOLD = 0.5

#: column quantum of the approximate path's gathered tiles: candidate
#: widths round up to a multiple of this (then to a power-of-two bucket),
#: and the recall/speedup accounting counts cost in (row_tile,
#: TILE_QUANTUM) tile units for the exact and approximate paths alike
TILE_QUANTUM = 64

#: permutations hashed per pass: the pass's int64 hashes are
#: postings x PERM_CHUNK x 8 bytes (0.6 GB for the 4.7 M postings of CSL)
PERM_CHUNK = 16

#: word rows expanded to (slot, term) pairs per pass: the pass's bit
#: intermediate is WORD_CHUNK x V x 32 bytes at most (1 GB at V = 2^16)
WORD_CHUNK = 512

_MASK32 = 0xFFFFFFFF
_SIGN = -(1 << 31)               # flips the sign bit of an int32 pattern


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


# ---------------------------------------------------------------------------
# Hash family
# ---------------------------------------------------------------------------


def hash_coefficients(num_perm: int, seed: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The family's (a, b) coefficients — (num_perm,) uint32 each, ``a``
    odd (units mod 2^32, so every ``h_p`` is a bijection over slot ids).
    Deterministic in (num_perm, seed): snapshots restore signatures that
    keep min-merging with freshly hashed blocks bit-compatibly."""
    if num_perm < 1:
        raise ValueError(f"num_perm must be >= 1, got {num_perm}")
    rng = np.random.default_rng(int(seed))
    a = rng.integers(0, 1 << 32, size=int(num_perm), dtype=np.uint32) | 1
    b = rng.integers(0, 1 << 32, size=int(num_perm), dtype=np.uint32)
    return a, b


def _set_bits(rows: torch.Tensor, base: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot, term) int64 pairs of every set bit of ``rows`` (U, V) int32
    bit patterns, where bit ``j`` of row ``u`` is slot ``base[u] + j``."""
    slots, terms = [], []
    shifts = torch.arange(32, dtype=torch.int32, device=rows.device)
    for u0 in range(0, rows.shape[0], WORD_CHUNK):
        blk = rows[u0:u0 + WORD_CHUNK]
        u, t = torch.nonzero(blk, as_tuple=True)
        bits = ((blk[u, t][:, None] >> shifts) & 1).bool()     # (n, 32)
        i, j = torch.nonzero(bits, as_tuple=True)
        slots.append(base[u0:u0 + WORD_CHUNK][u[i]] + j)
        terms.append(t[i])
    return torch.cat(slots), torch.cat(terms)


def _hash_min(slots: torch.Tensor, terms: torch.Tensor, v: int,
              a: np.ndarray, b: np.ndarray,
              perm_tile: int = PERM_CHUNK) -> torch.Tensor:
    """(V, P) signatures as int32 patterns: per term and permutation, the
    unsigned min of ``(a_p * slot + b_p) mod 2^32`` over the term's
    (slot, term) pairs, :data:`SIG_EMPTY` where it has none, hashed
    ``perm_tile`` permutations a pass (at least one, as the reference
    clamps it).  int64 keeps ``a * slot`` exact (a < 2^32, slot < 2^31)
    before the mask."""
    dev = slots.device
    p = len(a)
    step = max(int(perm_tile), 1)
    a_t = torch.from_numpy(np.asarray(a, np.int64)).to(dev)
    b_t = torch.from_numpy(np.asarray(b, np.int64)).to(dev)
    out = torch.empty((v, p), dtype=torch.int32, device=dev)
    for p0 in range(0, p, step):
        ac, bc = a_t[p0:p0 + step], b_t[p0:p0 + step]
        h = (slots[:, None] * ac[None, :] + bc[None, :]) & _MASK32
        m = torch.full((v, len(ac)), SIG_EMPTY, dtype=torch.int64,
                       device=dev)
        m.scatter_reduce_(0, terms[:, None].expand_as(h), h, "amin")
        out[:, p0:p0 + len(ac)] = (m - (m >= 1 << 31) * (1 << 32)).to(
            torch.int32)
    return out


def signatures_from_packed(packed: torch.Tensor, a: np.ndarray,
                           b: np.ndarray, *, slot0: int = 0,
                           perm_tile: int = PERM_CHUNK) -> torch.Tensor:
    """:func:`minhash_signatures` of word rows whose first bit is doc slot
    ``slot0`` (bit ``j`` of row ``u`` is slot ``slot0 + 32 u + j``): a doc
    shard passes its own first slot, so the shards' partial signatures
    min-merge into exactly the whole bitmap's."""
    base = slot0 + torch.arange(packed.shape[0], dtype=torch.int64,
                                device=packed.device) * 32
    slots, terms = _set_bits(packed, base)
    return _hash_min(slots, terms, packed.shape[1], a, b, perm_tile)


def minhash_signatures(packed: torch.Tensor, a: np.ndarray,
                       b: np.ndarray, *,
                       perm_tile: int = PERM_CHUNK) -> torch.Tensor:
    """Per-term MinHash signatures over the whole packed bitmap.

    packed: (W, V) int32 bit patterns; a/b: (P,) uint32 coefficients
    (:func:`hash_coefficients`).  Returns (V, P) int32 uint32 patterns —
    row ``v`` holds ``min_{d in postings(v)} (a_p * d + b_p)`` per
    permutation, :data:`SIG_EMPTY` where the term has no postings.
    ``perm_tile`` permutations are hashed a pass; it bounds the pass's
    memory and changes no result."""
    return signatures_from_packed(packed, a, b, perm_tile=perm_tile)


def block_signatures(packed: torch.Tensor, slots, a: np.ndarray,
                     b: np.ndarray, *,
                     perm_tile: int = PERM_CHUNK) -> torch.Tensor:
    """Signatures restricted to one ingest block's doc ``slots``.

    Gathers only the block's word rows off the live bitmap, keeps the
    block's bits of them, and hashes those postings — (V, P) int32
    patterns, :data:`SIG_EMPTY` where the block holds no postings for a
    term.  Min-merging every live block's signature reproduces
    :func:`minhash_signatures` over the live bitmap exactly, in any merge
    order."""
    slots = np.asarray(slots, np.int64)
    v, dev = packed.shape[1], packed.device
    if len(slots) == 0:
        return torch.full((v, len(a)), -1, dtype=torch.int32, device=dev)
    uw, pos = np.unique(slots // 32, return_inverse=True)
    own = np.zeros((len(uw),), np.uint32)
    np.bitwise_or.at(own, pos, np.uint32(1) << (slots % 32).astype(np.uint32))
    own_t = torch.from_numpy(own.view(np.int32)).to(dev)
    rows = packed[torch.from_numpy(uw).to(dev)] & own_t[:, None]
    set_slots, terms = _set_bits(rows, torch.from_numpy(uw * 32).to(dev))
    return _hash_min(set_slots, terms, v, a, b, perm_tile)


def _umin(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned min of int32 bit patterns."""
    return torch.minimum(x ^ _SIGN, y ^ _SIGN) ^ _SIGN


def merge_signatures(parts: Sequence[torch.Tensor], vocab_size: int,
                     num_perm: int, device="cpu") -> torch.Tensor:
    """Elementwise unsigned-min merge of per-block signatures —
    associative and commutative, so the result is invariant to ingest and
    merge order.  Empty input: the all-:data:`SIG_EMPTY` signature of an
    empty index, on ``device``."""
    if not parts:
        return torch.full((vocab_size, num_perm), -1, dtype=torch.int32,
                          device=device)
    return functools.reduce(_umin, parts)


# ---------------------------------------------------------------------------
# LSH banding math (host code, copied from the reference)
# ---------------------------------------------------------------------------


def lsh_probabilities(s, b: int, r: int):
    """P[some band collides | Jaccard s] = 1 - (1 - s^r)^b — the LSH
    S-curve for ``b`` bands of ``r`` rows (vectorizes over ``s``)."""
    s = np.asarray(s, np.float64)
    return 1.0 - (1.0 - s ** r) ** b


def _fp_fn_integrals(threshold: float, b: int, r: int,
                     n: int = 64) -> Tuple[float, float]:
    """(false-positive, false-negative) probability integrals of the
    (b, r) S-curve around ``threshold`` — midpoint rule: FP mass below the
    threshold is ∫_0^t P[cand|s] ds, FN mass above it ∫_t^1 (1 - P) ds."""
    t = float(threshold)
    xs_lo = t * (np.arange(n) + 0.5) / n
    xs_hi = t + (1.0 - t) * (np.arange(n) + 0.5) / n
    fp = float(np.sum(lsh_probabilities(xs_lo, b, r)) * (t / n))
    fn = float(np.sum(1.0 - lsh_probabilities(xs_hi, b, r))
               * ((1.0 - t) / n))
    return fp, fn


def lsh_params(threshold: float, num_perm: int, *,
               fn_weight: float = 0.75) -> Tuple[int, int]:
    """Optimal (bands, rows_per_band) for ``threshold`` under a
    ``num_perm`` budget: brute force over every (b, r) with ``b * r <=
    num_perm`` minimizing ``(1 - fn_weight) * FP + fn_weight * FN``.  Ties
    break toward more bands, then fewer rows.  (26, 4) at threshold 0.5
    and 128 permutations."""
    t = float(threshold)
    if not (0.0 < t < 1.0):
        raise ValueError(f"threshold must be in (0, 1), got {threshold}")
    p = int(num_perm)
    if p < 1:
        raise ValueError(f"num_perm must be >= 1, got {num_perm}")
    w_fn = float(fn_weight)
    if not (0.0 < w_fn < 1.0):
        raise ValueError(f"fn_weight must be in (0, 1), got {fn_weight}")
    best: Optional[Tuple[float, int, int]] = None
    for b in range(1, p + 1):
        for r in range(1, p // b + 1):
            fp, fn = _fp_fn_integrals(t, b, r)
            cost = (1.0 - w_fn) * fp + w_fn * fn
            key = (cost, -b, r)
            if best is None or key < best:
                best = key
                chosen = (b, r)
    return chosen


def candidate_columns(signatures: np.ndarray, *, b: int, r: int,
                      active: np.ndarray, row_tile: int
                      ) -> Tuple[List[Optional[np.ndarray]], int]:
    """LSH banding over ``signatures`` (V, P) uint32, unioned per row
    block.

    Terms equal on all ``r`` rows of any of the ``b`` bands share a
    bucket; every bucket co-membership is a candidate pair.  Terms with
    ``active`` False (df == 0) never join a bucket.  Returns
    ``(per_block, n_candidate_pairs)``: per_block[i] is the sorted unique
    global column ids block ``i`` must be counted against (None = no
    candidates, the block is skipped), n_candidate_pairs the number of
    distinct unordered candidate pairs."""
    sigs = np.ascontiguousarray(np.asarray(signatures, np.uint32))
    v = sigs.shape[0]
    if b * r > sigs.shape[1]:
        raise ValueError(f"b*r = {b}*{r} exceeds num_perm = {sigs.shape[1]}")
    act = np.asarray(active, bool)
    ids = np.flatnonzero(act)
    adj: Dict[int, set] = {}
    n_pairs = 0
    if len(ids) >= 2:
        banded = sigs[ids, :b * r].reshape(len(ids), b, r)
        for band in range(b):
            keys = np.ascontiguousarray(banded[:, band, :])
            view = keys.view([("", keys.dtype)] * r).ravel()
            order = np.argsort(view, kind="stable")
            sv = view[order]
            starts = np.flatnonzero(
                np.concatenate([[True], sv[1:] != sv[:-1]]))
            bounds = np.append(starts, len(sv))
            for s0, s1 in zip(bounds[:-1], bounds[1:]):
                if s1 - s0 < 2:
                    continue
                members = ids[order[s0:s1]]
                mset = set(int(m) for m in members)
                for m in mset:
                    cur = adj.setdefault(m, set())
                    before = len(cur)
                    cur.update(mset)
                    n_pairs += len(cur) - before
        # each term's set includes itself once it joined any bucket;
        # n_pairs double-counts (i,j)+(j,i) and counts each self once
        n_pairs = (n_pairs - len(adj)) // 2
    per_block: List[Optional[np.ndarray]] = []
    for r0 in range(0, _round_up(v, row_tile), row_tile):
        cols: set = set()
        for t in range(r0, min(r0 + row_tile, v)):
            nbrs = adj.get(t)
            if nbrs:
                cols.update(nbrs)
        if cols:
            arr = np.fromiter(cols, np.int32, len(cols))
            arr.sort()
            per_block.append(arr)
        else:
            per_block.append(None)
    return per_block, n_pairs


def pad_candidates(cols: np.ndarray, vocab_size: int) -> np.ndarray:
    """Pad a sorted candidate id array to its power-of-two
    :data:`TILE_QUANTUM` bucket (capped at the vocab's own padded width)
    with -1 sentinels; pad columns gather all-zero postings, so they can
    never produce a valid edge."""
    c = len(cols)
    cap = _round_up(vocab_size, TILE_QUANTUM)
    width = TILE_QUANTUM
    while width < c:
        width *= 2
    width = min(width, cap)        # cap >= c always, so width stays >= c
    out = np.full((width,), -1, np.int32)
    out[:c] = cols
    return out


def gathered_top_k(counts: torch.Tensor, cand_ids: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over one gathered candidate tile, mapped to global ids.

    counts: (B, C) exact counts over the gathered candidate columns;
    cand_ids: (C,) global term id per column (-1 on pad columns).
    Returns (weights int32, global ids int32), both (B, k), weight -1 /
    id 0 padding when C < k.  Candidates are gathered in ascending global
    id order, so ``lax.top_k``'s lower-slot-first tie break is
    lower-global-id-first (:func:`~repro_torch.kernels.ref.topk_lower_index`,
    never bare ``torch.topk``)."""
    c = counts.shape[-1]
    k_eff = min(k, c)
    w, loc = topk_lower_index(counts, k_eff)
    ids = cand_ids.clamp(min=0).to(torch.int32)[loc]
    if k_eff < k:
        w = torch.nn.functional.pad(w, (0, k - k_eff), value=-1)
        ids = torch.nn.functional.pad(ids, (0, k - k_eff), value=0)
    return w, ids


# ---------------------------------------------------------------------------
# Approximate-network result types and recall estimation
# ---------------------------------------------------------------------------


class ApproxStats(NamedTuple):
    """Pruning accounting of one approximate materialization, in
    (row_tile, :data:`TILE_QUANTUM`) tile units — ``tiles_counted /
    tiles_total`` is the share of the exact sweep's counting work the
    approximate path ran."""

    tiles_counted: int       # gathered tile units actually counted
    tiles_total: int         # tile units the exact path would count
    candidate_pairs: int     # distinct unordered LSH candidate pairs
    num_perm: int
    threshold: float
    bands: int
    rows_per_band: int

    @property
    def tiles_fraction(self) -> float:
        return self.tiles_counted / max(self.tiles_total, 1)


class ApproxCoocNetwork(NamedTuple):
    """A :class:`~repro_torch.core.network.CoocNetwork`-shaped result (the
    same first four fields, so every network consumer duck-types)
    carrying the sketch layer's accuracy and pruning metadata."""

    src: torch.Tensor     # (N,) int32
    dst: torch.Tensor     # (N,) int32
    weight: torch.Tensor  # (N,) int32 (0 for invalid slots)
    valid: torch.Tensor   # (N,) bool
    recall_estimate: float
    stats: ApproxStats

    @property
    def max_edges(self) -> int:
        return self.src.shape[0]

    def num_edges(self) -> int:
        return int(self.valid.sum())


def estimate_recall(signatures: np.ndarray, src: np.ndarray,
                    dst: np.ndarray, valid: np.ndarray, *, b: int,
                    r: int) -> float:
    """Sketch-theoretic recall estimate of an emitted edge set: mean LSH
    detection probability ``1 - (1 - s_hat^r)^b`` over the valid edges,
    ``s_hat`` the share of equal signature components of the two
    endpoints (the unbiased MinHash Jaccard estimate)."""
    ok = np.asarray(valid, bool)
    if not ok.any():
        return 1.0
    sigs = np.asarray(signatures)
    s = np.asarray(src)[ok].astype(np.int64)
    d = np.asarray(dst)[ok].astype(np.int64)
    s_hat = (sigs[s] == sigs[d]).mean(axis=1)
    return float(np.mean(lsh_probabilities(s_hat, b, r)))
