"""Mixture-of-Experts FFN (token-choice top-k, capacity-based, scatter
dispatch): a copy of ``repro.models.moe``.

Position-within-expert is a stable sort-based ranking (no (tokens, E)
one-hot), tokens scatter straight into the (E, C, d) expert buffers, the
experts run as one grouped product over their stacked (E, d, ff) weights,
and the combine is a gather and a per-token weighted sum.

Capacity C = max(ceil(T * top_k * capacity_factor / E), 1) in the
reference's float arithmetic; a token past its expert's capacity is
dropped (GShard), and its residual path still carries it.  The router is
fp32; its top-k keeps ``lax.top_k``'s order (equal probabilities: the
lower expert first).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.layers import draw_dense, mm


class MoE(nn.Module):
    """The reference's MoE parameters: ``router`` (d, E) fp32, ``w1`` /
    ``w3`` (E, d, ff) and ``w2`` (E, ff, d), and with shared experts
    ``shared_w1`` / ``shared_w3`` (d, n_shared * ff) and ``shared_w2``.

    With a ``generator`` (on ``device``'s type) the weights are drawn as
    the reference's ``init_moe_params`` draws them, N(0, 1) / sqrt(in);
    without one they are left uninitialised, to be filled from the
    reference's pytree."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 n_shared: int, *, dtype: torch.dtype, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)

        def weight(*shape, dt=dtype):
            w = (torch.empty(shape, dtype=dt, device=dev) if generator is None
                 else draw_dense(generator, shape, dt, dev))
            return nn.Parameter(w)

        self.router = weight(d_model, n_experts, dt=torch.float32)
        self.w1 = weight(n_experts, d_model, d_ff)
        self.w3 = weight(n_experts, d_model, d_ff)
        self.w2 = weight(n_experts, d_ff, d_model)
        self.n_shared = n_shared
        if n_shared:
            self.shared_w1 = weight(d_model, n_shared * d_ff)
            self.shared_w3 = weight(d_model, n_shared * d_ff)
            self.shared_w2 = weight(n_shared * d_ff, d_model)


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, n_shared: int, dtype: torch.dtype, *,
                    device="cuda") -> MoE:
    """An :class:`MoE` with weights drawn from ``generator``."""
    return MoE(d_model, d_ff, n_experts, n_shared, dtype=dtype,
               device=device, generator=generator)


def _position_in_expert(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Rank of each entry among entries with the same expert id, in input
    order (stable): sort-based, no (Tk, E) one-hot."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    idx = torch.arange(n, device=flat_e.device)
    first = torch.ones(n, dtype=torch.bool, device=flat_e.device)
    first[1:] = sorted_e[1:] != sorted_e[:-1]
    run_start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    pos_sorted = idx - run_start
    return torch.zeros_like(pos_sorted).scatter_(0, order, pos_sorted)


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: values descending, equal values
    the lower index first (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(model: MoE, x: torch.Tensor, *, top_k: int,
            capacity_factor: float, router_aux_weight: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (out (T, d), aux_loss ())."""
    t, d = x.shape
    e = model.router.shape[1]
    f32 = torch.float32

    logits = mm(x.to(f32), model.router)
    probs = torch.softmax(logits, dim=-1)                    # (T, E) fp32
    top_w, top_i = _top_k(probs, top_k)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)   # renormalise

    cap = int(math.ceil(t * top_k * capacity_factor / e))
    cap = max(cap, 1)

    flat_e = top_i.reshape(-1)                               # (T*k,)
    pos = _position_in_expert(flat_e, e)
    keep = pos < cap
    dest = flat_e * cap + pos                                # unique if kept
    token_of = torch.arange(t * top_k, device=x.device) // top_k

    # dispatch: scatter into (E*C, d) buffers; a dropped entry goes to one
    # spare row past the end (the reference's out-of-range drop)
    src = x[token_of]
    safe_dest = torch.where(keep, dest, e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, safe_dest, torch.where(keep[:, None], src, 0.0))
    buf = buf[:e * cap].reshape(e, cap, d)

    # the experts: grouped SwiGLU over the stacked weights
    dt = torch.promote_types(buf.dtype, model.w1.dtype)
    buf = buf.to(dt)
    h = torch.bmm(buf, model.w1.to(dt))
    g = torch.bmm(buf, model.w3.to(dt))
    h = h * torch.nn.functional.silu(g.to(f32)).to(h.dtype)
    out_buf = torch.bmm(h, model.w2.to(dt))

    # combine: gather back, weighted sum over the k choices
    flat_out = out_buf.reshape(e * cap, d)
    gathered = flat_out[torch.where(keep, dest, 0)]          # (T*k, d)
    w = (top_w.reshape(-1) * keep).to(x.dtype)
    y = torch.sum((gathered * w[:, None]).reshape(t, top_k, d), dim=1)

    # shared experts (the dense branch, DeepSeek/Kimi style)
    if model.n_shared:
        hs = mm(x, model.shared_w1)
        gs = mm(x, model.shared_w3)
        hs = hs * torch.nn.functional.silu(gs.to(f32)).to(hs.dtype)
        y = y + mm(hs, model.shared_w2)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    # (bincount would size its output from the ids: a wait for the card)
    f_e = torch.zeros(e, dtype=f32, device=x.device).index_add_(
        0, flat_e, torch.ones(flat_e.shape, dtype=f32, device=x.device)
    ) / (t * top_k)
    p_e = torch.mean(probs, dim=0)
    aux = router_aux_weight * e * torch.sum(f_e * p_e)
    return y, aux
