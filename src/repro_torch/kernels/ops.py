"""Public kernel wrappers: the device of the operands picks the path.

A CUDA tensor goes to the hand-written kernel (built at first use, see
:mod:`repro_torch.kernels.build`); a CPU tensor goes to the kernel's plain
version in :mod:`repro_torch.kernels.ref`.  There is no other path and no
fallback: a kernel that fails to build or launch raises.

:data:`LAUNCHES` counts the kernel launches of each wrapper (a wrapper adds
one where it launches its kernel and nowhere else), so a run can show that
its main path went through the kernels.  It is process-wide on purpose: it
counts the launches of the process's one set of kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"postings_counts": 0, "level_step": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"kernels run on cuda (hand-written) or cpu (plain "
                     f"version), not {x.device}")


def postings_counts(masks: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """counts[b, v] = sum_w popcount(masks[b, w] & packed[w, v]).

    masks (B, W), packed (W, V): int32 tensors holding uint32 bit patterns
    -> (B, V) int32.  Mirrors ``repro.kernels.ops.postings_counts``."""
    if _on_cuda(masks):
        from repro_torch.kernels.postings import postings_counts_cuda
        out = postings_counts_cuda(masks, packed)
        LAUNCHES["postings_counts"] += 1
        return out
    return ref.postings_counts_ref(masks, packed)


def level_step(masks: torch.Tensor, packed_t_pad: torch.Tensor,
               terms: torch.Tensor, valid: torch.Tensor,
               visited: torch.Tensor, *, v: int, k: int, dedup: bool = True):
    """One fused BFS level step: popcount counts + self/visited/valid
    masking + exact top-k.  Mirrors ``repro.kernels.ops.level_step``.

    masks (R, W) int32 with W <= W_pad; packed_t_pad (V_pad, W_pad) int32,
    the PRE-PADDED transposed postings (``QueryContext.packed_t_pad``: V to
    a multiple of 8, W to a multiple of 128, padded once per epoch); terms
    (R,) int32 (-1 = invalid); valid (R,) bool; visited (V,) bool for one
    query, or (Q, V) bool for a batch-major frontier whose row r belongs to
    query ``r // (R // Q)``.  Returns (weights, ids), both (R, k) int32, in
    exact ``lax.top_k`` order; ``k > v`` clamps and pads the missing slots
    with weight -1 / id 0.

    Refuses to pad its big operand: an artifact that is not the pre-padded
    one is an error, never a per-call pad.  The mask words past W read as
    zero inside the kernel, so the frontier is not padded either.
    """
    vp, wp = packed_t_pad.shape
    if vp % 8 or wp % 128 or vp < v:
        raise ValueError(
            f"packed_t_pad {tuple(packed_t_pad.shape)} is not the pre-padded "
            f"(V->8, W->128) artifact for v={v}; pass "
            "QueryContext.packed_t_pad() — level_step never pads it")
    if masks.shape[1] > wp:
        raise ValueError(f"masks have {masks.shape[1]} words, more than the "
                         f"artifact's {wp}")
    vis = visited if visited.dim() == 2 else visited[None, :]
    if masks.shape[0] % vis.shape[0]:
        raise ValueError(f"{masks.shape[0]} frontier rows do not split into "
                         f"{vis.shape[0]} queries")
    k_eff = min(k, v)
    if _on_cuda(masks):
        from repro_torch.kernels.level_step import level_step_cuda
        w, i = level_step_cuda(masks, packed_t_pad, terms, valid, vis,
                               v=v, k=k_eff, dedup=dedup)
        LAUNCHES["level_step"] += 1
    else:
        w, i = ref.level_step_ref(masks, packed_t_pad, terms, valid, vis,
                                  v=v, k=k_eff, dedup=dedup)
    if k_eff < k:
        pad = k - k_eff
        w = torch.nn.functional.pad(w, (0, pad), value=-1)
        i = torch.nn.functional.pad(i, (0, pad), value=0)
    return w, i
