"""Optimizers built from scratch: copies of ``repro.train.optimizer``'s
AdamW, Adafactor and SGD with momentum, with the reference's arithmetic
(``torch.optim``'s AdamW places eps and weight decay otherwise and has no
schedule, so it is not used).

    opt = make_optimizer(cfg)
    state = opt.init(params)
    params, state, stats = opt.update(grads, state, params)

``params`` and ``grads`` are pytrees of tensors in the reference's layout
(:mod:`repro_torch.pytree`; a model's is ``params_to_reference(cfg,
model)``), so every leaf, and Adafactor's factored statistics of a stack
of layers, is the reference's.  The state has the reference's structure
(``m``, ``v``, ``count``; ``m``, ``vr``, ``vc``, ``count``; ``m``,
``count``), ``count`` an int32 scalar.  ``update`` runs without a graph
and writes the new parameters and moments into the tensors it was given,
in place, and returns them: the reference's jit donates both, so their
old values are dead there too, and at dlrm-rm2's size (a 6.7 GB table)
the copies would not fit beside the state.  ``state_specs`` maps a
model's ``param_specs`` tree to the state's logical axes, as the
reference's does (:mod:`repro_torch.launch.sharding`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import pytree
from repro_torch.configs.base import BaseConfig
from repro_torch.models.layers import reference_tensor

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any, Dict]]
    state_specs: Optional[Callable[[Any], Any]] = None  # param specs -> state's


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def lr_schedule(cfg: BaseConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to 10% over 10,000 steps (fp32)."""
    s = step.to(F32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    decay_steps = 10000.0
    t = torch.clamp((s - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = 0.55 + 0.45 * torch.cos(math.pi * t)
    return cfg.learning_rate * warm * cos


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in pytree.leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return pytree.tree_map(lambda x: (x.to(F32) * scale).to(x.dtype),
                           tree), gn


def _clipped(cfg: BaseConfig, grads):
    if cfg.grad_clip > 0:
        return clip_by_global_norm(grads, cfg.grad_clip)
    return grads, global_norm(grads)


def _count0(params) -> torch.Tensor:
    dev = pytree.leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as fp32: itself when it already is (to be written in place),
    else a copy."""
    return x if x.dtype == F32 else x.to(F32)


def _store(dst: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``val`` written into ``dst`` (cast to its dtype) unless it is dst."""
    if val is not dst:
        dst.copy_(val)
    return dst


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(cfg: BaseConfig, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8) -> Optimizer:
    mdt = _dtype(cfg.moment_dtype)

    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=mdt)
        return {"m": pytree.tree_map(z, params),
                "v": pytree.tree_map(z, params), "count": _count0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        grads, gn = _clipped(cfg, grads)
        c = state["count"] + 1
        lr = lr_schedule(cfg, c)
        bc1 = 1 - torch.pow(b1, c.to(F32))
        bc2 = 1 - torch.pow(b2, c.to(F32))

        def upd(p, g, m, v):
            # the reference's expressions, op by op, in two scratch tensors
            gf = g.to(F32)
            mf, vf, pf = _f32(m), _f32(v), _f32(p)
            t = gf * (1 - b1)
            mf.mul_(b1).add_(t)                      # b1 m + (1 - b1) g
            torch.mul(gf, 1 - b2, out=t)
            t.mul_(gf)
            vf.mul_(b2).add_(t)                      # b2 v + (1 - b2) g g
            torch.div(vf, bc2, out=t)
            t.sqrt_().add_(eps)
            s = mf / bc1
            s.div_(t)                                # (m/bc1)/(sqrt(v/bc2)+eps)
            torch.mul(pf, cfg.weight_decay, out=t)
            s.add_(t).mul_(lr)
            pf.sub_(s)                               # p - lr (step + wd p)
            _store(p, pf)
            _store(m, mf)
            _store(v, vf)

        for leaf in zip(*(pytree.leaves(t) for t in
                          (params, grads, state["m"], state["v"]))):
            upd(*leaf)
        return params, {"m": state["m"], "v": state["v"], "count": c}, \
            {"grad_norm": gn, "lr": lr}

    def state_specs(pspecs):
        return {"m": pspecs, "v": pspecs, "count": ()}

    return Optimizer(init, update, state_specs)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; optional bf16 first moment)
# ---------------------------------------------------------------------------


def adafactor(cfg: BaseConfig, b1: float = 0.9, decay: float = 0.99,
              eps: float = 1e-30) -> Optimizer:
    mdt = _dtype(cfg.moment_dtype)

    def _factored(p) -> bool:
        return p.dim() >= 2

    def init(params):
        def vrow(p):
            return (torch.zeros(p.shape[:-1], dtype=F32, device=p.device)
                    if _factored(p) else torch.zeros_like(p, dtype=F32))

        def vcol(p):
            return (torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32,
                                device=p.device)
                    if _factored(p) else
                    torch.zeros((), dtype=F32, device=p.device))

        return {
            "m": pytree.tree_map(lambda p: torch.zeros_like(p, dtype=mdt),
                                 params),
            "vr": pytree.tree_map(vrow, params),
            "vc": pytree.tree_map(vcol, params),
            "count": _count0(params),
        }

    @torch.no_grad()
    def update(grads, state, params):
        grads, gn = _clipped(cfg, grads)
        c = state["count"] + 1
        lr = lr_schedule(cfg, c)

        def upd(p, g, m, vr, vc):
            gf = g.to(F32)
            g2 = gf * gf + eps
            if _factored(p):
                vr_n = decay * vr + (1 - decay) * torch.mean(g2, dim=-1)
                vc_n = decay * vc + (1 - decay) * torch.mean(g2, dim=-2)
                denom = torch.sqrt(
                    vr_n[..., None] * vc_n[..., None, :]
                    / torch.clamp(torch.mean(vr_n, dim=-1, keepdim=True)
                                  [..., None], min=eps))
            else:
                vr_n = decay * vr + (1 - decay) * g2
                vc_n = vc
                denom = torch.sqrt(vr_n)
            u = gf / torch.clamp(denom, min=1e-12)
            # update clipping (Shazeer): RMS(u) <= 1
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms, min=1.0)
            mf = b1 * m.to(F32) + (1 - b1) * u
            pf = p.to(F32)
            pn = pf - lr * (mf + cfg.weight_decay * pf)
            p.copy_(pn)
            m.copy_(mf)
            vr.copy_(vr_n)
            vc.copy_(vc_n)

        for leaf in zip(*(pytree.leaves(t) for t in
                          (params, grads, state["m"], state["vr"],
                           state["vc"]))):
            upd(*leaf)
        return params, {"m": state["m"], "vr": state["vr"],
                        "vc": state["vc"], "count": c}, \
            {"grad_norm": gn, "lr": lr}

    def state_specs(pspecs):
        def vrow_spec(s):
            return s[:-1] if len(s) >= 2 else s

        def vcol_spec(s):
            return s[:-2] + s[-1:] if len(s) >= 2 else ()

        return {
            "m": pspecs,
            "vr": pytree.tree_map(vrow_spec, pspecs,
                                  is_leaf=pytree.is_logical),
            "vc": pytree.tree_map(vcol_spec, pspecs,
                                  is_leaf=pytree.is_logical),
            "count": (),
        }

    return Optimizer(init, update, state_specs)


# ---------------------------------------------------------------------------
# SGD + momentum
# ---------------------------------------------------------------------------


def sgdm(cfg: BaseConfig, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"m": pytree.tree_map(
                    lambda p: torch.zeros_like(p, dtype=F32), params),
                "count": _count0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        grads, gn = _clipped(cfg, grads)
        c = state["count"] + 1
        lr = lr_schedule(cfg, c)

        def upd(p, g, m):
            mf = momentum * m + g.to(F32)
            p.copy_(p.to(F32) - lr * mf)
            m.copy_(mf)

        for leaf in zip(*(pytree.leaves(t) for t in
                          (params, grads, state["m"]))):
            upd(*leaf)
        return params, {"m": state["m"], "count": c}, \
            {"grad_norm": gn, "lr": lr}

    def state_specs(pspecs):
        return {"m": pspecs, "count": ()}

    return Optimizer(init, update, state_specs)


def make_optimizer(cfg: BaseConfig) -> Optimizer:
    if cfg.optimizer == "adamw":
        return adamw(cfg)
    if cfg.optimizer == "adafactor":
        return adafactor(cfg)
    if cfg.optimizer == "sgdm":
        return sgdm(cfg)
    raise ValueError(cfg.optimizer)


# ---------------------------------------------------------------------------
# The reference's state across
# ---------------------------------------------------------------------------


def opt_state_to_reference(state) -> Any:
    """The state as the reference's pytree on the host: the same keys,
    shapes and dtypes, each leaf a detached CPU copy (``np.asarray`` of
    each gives the reference's leaf; bf16 leaves need a view, numpy has
    no bf16)."""
    return pytree.tree_map(lambda t: t.detach().to("cpu", copy=True), state)


def opt_state_from_reference(state, device="cuda") -> Any:
    """The reference's optimizer state (numpy or JAX leaves, bf16
    included, or tensors) as tensors on ``device``, each in its own
    dtype."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    return pytree.tree_map(lambda a: reference_tensor(a).to(dev), state)
