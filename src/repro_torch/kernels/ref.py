"""Plain PyTorch versions of the port's hand-written kernels.

Each function here computes exactly what its CUDA kernel computes, in
ordinary tensor code: the CPU path of :mod:`repro_torch.kernels.ops`, the
oracle of the tests, and the reference ``chip_smoke.py`` holds each kernel
against on the card.  A CUDA tensor never reaches these functions through
``ops``.  Two exceptions outside ``ops``: :func:`postings_counts_ref` is also
the served ``"popcount"`` count method on every device
(``core.inverted_index.doc_freq_under_batch``), and :func:`row_top_k_ref`
the whole-network top-k for a k above the kernel's limit
(``core.materialize._row_top_k``), so a change to either changes served
answers and speed, not only the yardstick.

Bitmaps are int32 tensors holding uint32 bit patterns (torch's uint32 has
no ``>>`` on the CPU).  Every arithmetic shift below is masked, or applied
to a value whose sign bit is already clear, so the results are the
unsigned ones bit for bit.

The AND + popcount over a (B, W) x (W, V) pair materialises a (B, W, V)
intermediate, and the co-occurrence product a float64 copy of its right
operand; every count function walks its columns in chunks so that such an
intermediate stays under ``chunk_bytes`` whatever the shapes.  Chunking
changes no result: each column's count is computed whole inside one chunk.
"""
from __future__ import annotations

import torch

#: byte budget of one chunk's (B, W, chunk) AND intermediate
CHUNK_BYTES = 256 << 20

_TWO32 = 1 << 32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element population count of int32 bit patterns.

    SWAR over the low 31 bits (non-negative, so every shift is logical and
    no step overflows int32), plus one for the sign bit."""
    y = x & 0x7FFFFFFF
    y = y - ((y >> 1) & 0x55555555)
    y = (y & 0x33333333) + ((y >> 2) & 0x33333333)
    y = (y + (y >> 4)) & 0x0F0F0F0F
    y = y + (y >> 8)
    y = (y + (y >> 16)) & 0x3F
    return y + (x < 0).to(torch.int32)


def _columns_per_chunk(rows: int, words: int, chunk_bytes: int) -> int:
    return max(1, chunk_bytes // max(1, 4 * rows * words))


def postings_counts_ref(masks: torch.Tensor, packed: torch.Tensor, *,
                        chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """counts[b, v] = sum_w popcount(masks[b, w] & packed[w, v]).

    masks (B, W) and packed (W, V) int32 bit patterns -> (B, V) int32."""
    b, w = masks.shape
    v = packed.shape[1]
    out = torch.empty((b, v), dtype=torch.int32, device=masks.device)
    step = _columns_per_chunk(b, w, chunk_bytes)
    for c0 in range(0, v, step):
        anded = masks[:, :, None] & packed[None, :, c0:c0 + step]
        out[:, c0:c0 + step] = popcount32(anded).sum(dim=1, dtype=torch.int32)
    return out


def active_words_ref(masks: torch.Tensor, rows: int):
    """The postings kernel's compaction: for each tile of ``rows`` mask
    rows (the last one ragged), the words at which any row is nonzero.

    masks (B, W) int32 -> (words (T, W) int32, n (T,) int32), T =
    ceil(B / rows): ``words[t, :n[t]]`` ascending, -1 after them."""
    b, w = masks.shape
    t = -(-b // rows)
    tiles = torch.nn.functional.pad(masks != 0, (0, 0, 0, t * rows - b))
    active = tiles.reshape(t, rows, w).any(dim=1)               # (T, W)
    n = active.sum(dim=1, dtype=torch.int32)
    order = torch.sort((~active).to(torch.int8), dim=1, stable=True).indices
    first = torch.arange(w, device=masks.device)[None, :] < n[:, None]
    return torch.where(first, order, -1).to(torch.int32), n


def cooccur_counts_ref(x_l: torch.Tensor, x_r: torch.Tensor, *,
                       chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """C = x_l^T @ x_r over 0/1 incidence: x_l (D, Vl), x_r (D, Vr) int8
    -> (Vl, Vr) int32.

    Integer ``mm`` does not exist on CUDA and float32 is exact only below
    2^24 docs, so the product runs in float64 (exact for any D this system
    holds), one chunk of ``x_r``'s columns at a time so that each chunk's
    float64 copy stays under ``chunk_bytes``."""
    d, vl = x_l.shape
    vr = x_r.shape[1]
    out = torch.empty((vl, vr), dtype=torch.int32, device=x_l.device)
    lt = x_l.t().to(torch.float64)
    step = max(1, chunk_bytes // max(1, 8 * d))
    for c0 in range(0, vr, step):
        rt = x_r[:, c0:c0 + step].to(torch.float64)
        out[:, c0:c0 + step] = (lt @ rt).to(torch.int32)
    return out


def topk_lower_index(x: torch.Tensor, k: int):
    """Exact ``lax.top_k`` over the last axis: values descending, equal
    values lower index first.  ``k <= x.shape[-1]``.

    ``torch.topk`` promises no order among ties, so each value is packed
    with its reversed index into one int64 key; keys are unique, and the
    key order is the ``lax.top_k`` order.  Returns (values int32, indices
    int64)."""
    n = x.shape[-1]
    rev = (n - 1) - torch.arange(n, dtype=torch.int64, device=x.device)
    key = x.to(torch.int64) * _TWO32 + rev
    top = torch.topk(key, k, dim=-1, largest=True, sorted=True).values
    val = torch.div(top, _TWO32, rounding_mode="floor")
    idx = (n - 1) - (top - val * _TWO32)
    return val.to(torch.int32), idx


def row_top_k_ref(counts: torch.Tensor, r0: int, k: int):
    """Each row's exact top-k of a row block's (R, V) counts, row ``r``
    being term ``r0 + r``, its self pair excluded: column ``min(r0 + r,
    V - 1)`` counts -1, below every zero count (a pad row past V hides
    column V - 1).  ``lax.top_k`` order; ``k > V`` clamps to V and pads
    the missing slots with weight -1 / id 0, as ``chunked_top_k`` does.
    Returns (weights (R, k) int32, ids (R, k) int64).  The plain version
    of ``csrc/row_topk.cu``."""
    r, v = counts.shape
    rows = torch.arange(r, device=counts.device)
    counts = counts.clone()
    counts[rows, (rows + r0).clamp(max=v - 1)] = -1
    k_eff = min(k, v)
    w, i = topk_lower_index(counts, k_eff)
    if k_eff < k:
        w = torch.nn.functional.pad(w, (0, k - k_eff), value=-1)
        i = torch.nn.functional.pad(i, (0, k - k_eff), value=0)
    return w, i


def masked_counts(counts: torch.Tensor, terms: torch.Tensor,
                  valid: torch.Tensor, visited_rows, v: int) -> torch.Tensor:
    """The level step's masking rules on a (R, ncols) count block: the
    row's own term and (when ``visited_rows`` is given) visited columns go
    to -1, invalid rows go to -1, and padding columns (>= v) go to -2,
    strictly below every real candidate."""
    cols = torch.arange(counts.shape[1], device=counts.device)
    counts = torch.where(cols[None, :] == terms.clamp(min=0)[:, None],
                         -1, counts)
    if visited_rows is not None:
        counts = torch.where(visited_rows, -1, counts)
    counts = torch.where(valid[:, None], counts, -1)
    return torch.where(cols[None, :] >= v, -2, counts).to(torch.int32)


def level_step_ref(masks: torch.Tensor, packed: torch.Tensor,
                   terms: torch.Tensor, valid: torch.Tensor,
                   visited: torch.Tensor, *, v: int, k: int, dedup: bool,
                   chunk_bytes: int = CHUNK_BYTES):
    """One fused BFS level: AND + popcount counts over the postings, the
    masking rules, exact top-k.

    masks (R, W) int32; packed (W, V) int32 with V >= v, columns past v
    being padding; terms (R,) int32; valid (R,) bool; visited (Q, v) bool,
    where row r belongs to query ``r // (R // Q)``.  ``k <= v``.  Returns
    (weights, ids), both (R, k) int32."""
    r = masks.shape[0]
    vp = packed.shape[1]
    q = visited.shape[0]
    counts = postings_counts_ref(masks, packed, chunk_bytes=chunk_bytes)
    vis = None
    if dedup:
        vis = torch.zeros((q, vp), dtype=torch.bool, device=masks.device)
        vis[:, :v] = visited
        vis = vis.repeat_interleave(r // q, dim=0)
    counts = masked_counts(counts, terms, valid, vis, v)
    w, i = topk_lower_index(counts, k)
    return w, i.to(torch.int32)


def dot_interaction_ref(x: torch.Tensor, *,
                        chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """DLRM dot interaction: x (B, F, E) -> (B, F (F - 1) / 2), the strict
    lower triangle of each sample's Gram matrix, row-major over i > j,
    accumulated in fp32 (float64 for a float64 x) and returned in x's
    dtype (the contract of ``repro.kernels.ref.dot_interaction_ref``).
    Samples go through in chunks whose (chunk, F, F) fp32 Gram stays
    under ``chunk_bytes``; chunking changes no result."""
    b, f, _ = x.shape
    ii, jj = torch.tril_indices(f, f, offset=-1, device=x.device)
    out = torch.empty((b, ii.numel()), dtype=x.dtype, device=x.device)
    step = max(1, chunk_bytes // max(1, 4 * f * f))
    for s0 in range(0, b, step):
        xf = x[s0:s0 + step].to(torch.promote_types(x.dtype, torch.float32))
        gram = torch.bmm(xf, xf.transpose(1, 2))
        out[s0:s0 + step] = gram[:, ii, jj].to(x.dtype)
    return out


def dot_interaction_grad_ref(x: torch.Tensor, g: torch.Tensor, *,
                             chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """The gradient of :func:`dot_interaction_ref` with respect to x: for
    each sample ``dX = (G + G^T) X``, G the (F, F) matrix that holds ``g``
    (B, F (F - 1) / 2) at the strict lower triangle (i > j, row-major, as
    the forward orders its pairs) and zero elsewhere.  Accumulated in fp32
    (float64 for a float64 x) and returned in x's dtype; chunked as the
    forward is."""
    b, f, e = x.shape
    ii, jj = torch.tril_indices(f, f, offset=-1, device=x.device)
    out = torch.empty_like(x)
    acc = torch.promote_types(x.dtype, torch.float32)   # float64 stays
    step = max(1, chunk_bytes // max(1, 4 * f * max(f, e)))
    for s0 in range(0, b, step):
        gc = g[s0:s0 + step].to(acc)
        gm = torch.zeros((gc.shape[0], f, f), dtype=acc, device=x.device)
        gm[:, ii, jj] = gc
        gm = gm + gm.transpose(1, 2)
        out[s0:s0 + step] = torch.bmm(gm, x[s0:s0 + step].to(acc)).to(x.dtype)
    return out


#: the Pallas decode kernel's masked score and initial running max
DECODE_NEG = -1e30


def decode_lengths(length, b: int, s: int, device) -> torch.Tensor:
    """``length`` (a scalar or (B,)) as a (B,) int32 tensor on ``device``,
    clamped to [0, S]."""
    ln = torch.as_tensor(length, dtype=torch.int32, device=device)
    return torch.broadcast_to(ln, (b,)).clamp(0, s).contiguous()


def decode_pad(s: int, chunk: int) -> int:
    """S padded to the decode chunk, as the reference wrapper pads it
    (chunk = min(chunk, S))."""
    ck = min(chunk, s)
    return -(-s // ck) * ck


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length, *, chunk: int = 512,
                     chunk_bytes: int = 4 << 30) -> torch.Tensor:
    """GQA decode attention with the Pallas kernel's arithmetic
    (``repro/kernels/flash_decode.py``), not the exact-softmax oracle's.

    q (B, Hq, d); k, v (B, S, Hkv, d), fp32 or bf16; ``length`` a scalar
    or (B,): the valid prefix of each row's cache, clamped to [0, S].
    Returns (B, Hq, d) in q's dtype, computed in fp32.  Query head h reads
    KV head ``h // (Hq // Hkv)``.

    As in the Pallas kernel, masked scores are -1e30 (not -inf), the
    running max starts at -1e30, the weighted sum is divided by
    ``max(l, 1e-30)``, and S is taken as padded with zeros to a multiple of
    ``min(chunk, S)``.  For every length >= 1 that equals the exact
    softmax.  A row of length 0 has every score at -1e30, so every padded
    position weighs 1 and the row gives sum(V[:S]) / S_pad, as
    ``repro.kernels.ops.flash_decode(..., backend="interpret", chunk=c)``
    does; the reference's exact oracle gives NaN there and its XLA path
    the mean over S.  The softmax is taken in one pass over the whole row
    (the padded positions enter its sum analytically), which equals the
    kernel's running form up to fp32 rounding.  Rows go through in chunks
    whose fp32 copy of K and V stays under ``chunk_bytes``."""
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    s_pad = decode_pad(s, chunk)
    ln = decode_lengths(length, b, s, q.device)
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    scale = torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    pos = torch.arange(s, device=q.device)
    step = max(1, chunk_bytes // max(1, 8 * s * hkv * d))
    for b0 in range(0, b, step):
        sl = slice(b0, b0 + step)
        qf = q[sl].to(torch.float32).reshape(-1, hkv, g, d)
        kf = k[sl].to(torch.float32)
        vf = v[sl].to(torch.float32)
        scores = torch.einsum("bhgd,bshd->bhgs", qf, kf) / scale
        valid = pos[None, :] < ln[sl, None]                   # (b, S)
        scores = torch.where(valid[:, None, None, :], scores, DECODE_NEG)
        m = scores.amax(dim=-1, keepdim=True)                 # >= -1e30
        p = torch.exp(scores - m)
        # the S_pad - S zero positions: score -1e30, so they weigh 1 only
        # where every score is masked (m == -1e30), else 0
        l = p.sum(dim=-1, keepdim=True) + (s_pad - s) * torch.exp(DECODE_NEG - m)
        acc = torch.einsum("bhgs,bshd->bhgd", p, vf)
        o = acc / torch.clamp(l, min=1e-30)
        out[sl] = o.reshape(-1, hq, d).to(q.dtype)
    return out
