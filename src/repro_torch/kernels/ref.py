"""Plain PyTorch versions of the port's hand-written kernels.

Each function here computes exactly what its CUDA kernel computes, in
ordinary tensor code: the CPU path of :mod:`repro_torch.kernels.ops`, the
oracle of the tests, and the reference ``chip_smoke.py`` holds each kernel
against on the card.  A CUDA tensor never reaches these functions through
``ops``.  One exception outside ``ops``: :func:`postings_counts_ref` is also
the served ``"popcount"`` count method on every device
(``core.inverted_index.doc_freq_under_batch``), so a change to it changes
that method's answers and speed, not only the yardstick.

Bitmaps are int32 tensors holding uint32 bit patterns (torch's uint32 has
no ``>>`` on the CPU).  Every arithmetic shift below is masked, or applied
to a value whose sign bit is already clear, so the results are the
unsigned ones bit for bit.

The AND + popcount over a (B, W) x (W, V) pair materialises a (B, W, V)
intermediate; both count functions walk V in chunks so that intermediate
stays under ``chunk_bytes`` whatever the shapes.  Chunking changes no
result: each column's count is computed whole inside one chunk.
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


def level_step_ref(masks: torch.Tensor, packed_t_pad: torch.Tensor,
                   terms: torch.Tensor, valid: torch.Tensor,
                   visited: torch.Tensor, *, v: int, k: int, dedup: bool,
                   chunk_bytes: int = CHUNK_BYTES):
    """One fused BFS level: AND + popcount counts over the padded
    transposed postings, the masking rules, exact top-k.

    masks (R, Wm) int32 with Wm <= W_pad; packed_t_pad (V_pad, W_pad)
    int32; terms (R,) int32; valid (R,) bool; visited (Q, v) bool, where
    row r belongs to query ``r // (R // Q)``.  ``k <= v``.  Returns
    (weights, ids), both (R, k) int32."""
    r, wm = masks.shape
    vp = packed_t_pad.shape[0]
    q = visited.shape[0]
    counts = torch.empty((r, vp), dtype=torch.int32, device=masks.device)
    step = _columns_per_chunk(r, wm, chunk_bytes)
    for c0 in range(0, vp, step):
        pt = packed_t_pad[c0:c0 + step, :wm]
        anded = masks[:, None, :] & pt[None, :, :]
        counts[:, c0:c0 + step] = popcount32(anded).sum(dim=2,
                                                        dtype=torch.int32)
    vis = None
    if dedup:
        vis = torch.zeros((q, vp), dtype=torch.bool, device=masks.device)
        vis[:, :v] = visited
        vis = vis.repeat_interleave(r // q, dim=0)
    counts = masked_counts(counts, terms, valid, vis, v)
    w, i = topk_lower_index(counts, k)
    return w, i.to(torch.int32)
