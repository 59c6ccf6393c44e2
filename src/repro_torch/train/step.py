"""Train-step factory: gradient accumulation (microbatching) and the
optimizer, a copy of ``repro.train.step``.

``make_train_step(cfg, loss_fn, optimizer)`` returns ``step(model,
opt_state, batch) -> (model, opt_state, metrics)``; ``loss_fn(model,
batch) -> (loss, metrics)``.  The gradient of every parameter comes from
``torch.autograd.grad`` (zero for one the loss does not reach, as
``jax.grad`` gives it), in the reference's params layout
(:func:`repro_torch.pytree.module_tree`), and one ``optimizer.update``
writes the new weights into the model.  With ``cfg.microbatches > 1``
the batch splits on its leading axis, and each microbatch's gradient
enters the sum as ``g.to(accum_dtype) / n``, its loss as ``loss / n``;
the sums are cast back to each parameter's dtype.  ``single`` returns the
loss's metrics and the optimizer's, ``accumulated`` the mean loss and the
optimizer's.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch import pytree
from repro_torch.configs.base import BaseConfig
from repro_torch.train.optimizer import Optimizer


def _split_batch(batch: Dict, n: int, i: int) -> Dict:
    """Microbatch ``i`` of ``n``: each leaf (B, ...) as (n, B/n, ...)[i]."""
    def r(x):
        b = x.shape[0]
        assert b % n == 0, (b, n)
        return x.reshape((n, b // n) + tuple(x.shape[1:]))[i]
    return {k: r(v) for k, v in batch.items()}


def loss_and_grads(loss_fn: Callable, model: torch.nn.Module, batch):
    """(loss, metrics, {name: gradient}), all detached; a parameter the
    loss does not reach gets a zero gradient."""
    named = list(model.named_parameters())
    with torch.enable_grad():
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
    out = {n: torch.zeros_like(p) if g is None else g
           for (n, p), g in zip(named, grads)}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, out


def apply_update(optimizer: Optimizer, model: torch.nn.Module, opt_state,
                 grads: Dict[str, torch.Tensor]):
    """One ``optimizer.update`` of the model's weights from named
    gradients, written back into the model.  Returns (opt_state,
    stats)."""
    params = pytree.module_tree(model)
    params, opt_state, stats = optimizer.update(
        pytree.module_tree(model, grads), opt_state, params)
    pytree.load_module_tree(model, params)
    return opt_state, stats


def make_train_step(cfg: BaseConfig, loss_fn: Callable, optimizer: Optimizer,
                    accum_dtype=torch.float32) -> Callable:
    """loss_fn(model, batch) -> (loss, metrics)."""

    def single(model, opt_state, batch):
        _, metrics, grads = loss_and_grads(loss_fn, model, batch)
        opt_state, stats = apply_update(optimizer, model, opt_state, grads)
        return model, opt_state, {**metrics, **stats}

    def accumulated(model, opt_state, batch):
        n = cfg.microbatches
        named = dict(model.named_parameters())
        acc = {k: torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
               for k, p in named.items()}
        loss_acc = None
        for i in range(n):
            loss, _, grads = loss_and_grads(loss_fn, model,
                                            _split_batch(batch, n, i))
            for k, g in grads.items():
                acc[k].add_(g.to(accum_dtype) / n)
            part = loss / n
            loss_acc = (torch.zeros((), dtype=torch.float32,
                                    device=loss.device)
                        if loss_acc is None else loss_acc) + part
        grads = {k: acc[k].to(named[k].dtype) for k in named}
        opt_state, stats = apply_update(optimizer, model, opt_state, grads)
        return model, opt_state, {"loss": loss_acc, **stats}

    return accumulated if cfg.microbatches > 1 else single
