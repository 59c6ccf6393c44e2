"""GIN (Graph Isomorphism Network) by gather and scatter-add message
passing: the port of ``repro.models.gnn``, differentiable.

GIN update: h' = LN(relu(MLP((1 + eps) * h + sum_{j in N(i)} h_j))), with
LayerNorm where the original GIN has BatchNorm (the reference's
substitution, kept).  A layer gathers the source rows of every edge
(``index_select``) and sums them into their destinations (``index_add_``,
the reference's ``segment_sum``).  On a CUDA device ``index_add_`` on fp32
adds with atomics, so the order of each node's sum, and the last bits of
its value, may change from run to run; on the CPU it adds in edge order.
``edge_mask`` zeroes the padded edges of a fixed-shape sampled subgraph.

The fp32 products run in full fp32 (refused on a card while TF32 is
allowed).  ``learnable_eps`` matters only to a gradient: the forward reads
``eps`` either way, and without it ``eps`` is detached (the reference's
``stop_gradient``), so its gradient is zero.  Everything runs on ``cuda``
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch import pytree
from repro_torch.configs.base import GNNConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import (ParamMaker, assign_from_reference, mm,
                                       reference_tensor, require_full_fp32)


class GINLayer(nn.Module):
    """``w1`` (d_in, d) / ``b1``, ``w2`` (d, d) / ``b2``, the LayerNorm
    gain ``ln`` and ``eps``, an fp32 scalar."""

    def __init__(self, d_in: int, d: int, mk: ParamMaker):
        super().__init__()
        self.w1, self.b1 = mk.dense(d_in, d), mk.const((d,), 0.0)
        self.w2, self.b2 = mk.dense(d, d), mk.const((d,), 0.0)
        self.ln = mk.const((d,), 1.0)
        self.eps = mk.const((), 0.0, dtype=torch.float32)


class GIN(nn.Module):
    """``n_layers`` :class:`GINLayer` (``layers``), then the classifier
    ``out`` (d_hidden, n_classes) / ``out_b``.

    With a ``generator`` (a ``torch.Generator`` on ``device``'s type) the
    weights are drawn as the reference's ``init_gin`` draws them: dense
    layers N(0, 1) / sqrt(in), zero biases and ``eps``, unit gains.
    Without one the dense layers are left uninitialised, to be filled by
    :func:`params_from_reference`."""

    def __init__(self, cfg: GNNConfig, d_feat: int, n_classes: int, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        mk = ParamMaker(dtype, resolve_device(device), generator)
        self.cfg = cfg
        d = cfg.d_hidden
        self.layers = nn.ModuleList([
            GINLayer(d_feat if i == 0 else d, d, mk)
            for i in range(cfg.n_layers)])
        self.out = mk.dense(d, n_classes)
        self.out_b = mk.const((n_classes,), 0.0)


def init_gin(cfg: GNNConfig, generator: torch.Generator, d_feat: int,
             n_classes: int, *, device="cuda",
             dtype: torch.dtype = torch.float32) -> GIN:
    """A GIN of ``cfg`` over ``d_feat`` input features and ``n_classes``
    classes, weights drawn from ``generator``."""
    return GIN(cfg, d_feat, n_classes, generator=generator, device=device,
               dtype=dtype)


def params_from_reference(cfg: GNNConfig, params: Mapping,
                          device="cuda") -> GIN:
    """The reference's ``init_gin`` pytree (``{"layers": [{"w1", "b1",
    "w2", "b2", "ln", "eps"}, ...], "out", "out_b"}``, as numpy arrays) as
    a :class:`GIN` on ``device``, in the dtype of its weights."""
    w1 = reference_tensor(params["layers"][0]["w1"])
    out = reference_tensor(params["out"])
    model = GIN(cfg, w1.shape[0], out.shape[1], device=device,
                dtype=w1.dtype)
    tree = dict(params, layers={str(i): lp
                                for i, lp in enumerate(params["layers"])})
    assign_from_reference(model, tree)
    return model


def params_to_reference(cfg: GNNConfig, model: GIN):
    """The inverse of :func:`params_from_reference`: the reference's
    ``init_gin`` pytree of the module's weights, as detached tensors that
    share their storage (``{"layers": [...], "out", "out_b"}``: the
    parameters' dotted names are the pytree's paths)."""
    return pytree.module_tree(model)


def param_specs(cfg: GNNConfig, params) -> Dict:
    """GIN params are tiny -> replicated everywhere: the reference's tree
    of logical axes, over ``params`` in the reference's layout
    (:func:`params_to_reference`; a module is taken to it)."""
    if isinstance(params, nn.Module):
        params = params_to_reference(cfg, params)
    return pytree.tree_map(lambda x: tuple([None] * x.dim()), params)


def _layer_norm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """LayerNorm without a bias, over the population variance (``jnp.var``;
    ``torch.var`` needs ``correction=0`` for it)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + 1e-5) * g).to(x.dtype)


def _aggregate(h: torch.Tensor, edge_src: torch.Tensor,
               edge_dst: torch.Tensor,
               edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum aggregation: each node's sum of its in-edges' source rows (N,
    d), the masked edges adding zero."""
    msg = torch.index_select(h, 0, edge_src)               # (E, d) gather
    if edge_mask is not None:
        msg *= edge_mask[:, None].to(msg.dtype)
    agg = torch.zeros_like(h)
    return agg.index_add_(0, edge_dst, msg)


def gin_forward(cfg: GNNConfig, model: GIN, x: torch.Tensor,
                edge_src: torch.Tensor, edge_dst: torch.Tensor,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N, F); edge_src / edge_dst (E,) int -> node embeddings (N,
    d_hidden).  ``edge_mask`` (E,) masks padded edges."""
    require_full_fp32(x, "GIN's layers")
    h = x
    for lp in model.layers:
        agg = _aggregate(h, edge_src, edge_dst, edge_mask)
        eps = lp.eps if cfg.learnable_eps else lp.eps.detach()
        z = (1.0 + eps).to(h.dtype) * h + agg
        del agg
        a = torch.relu(mm(z, lp.w1) + lp.b1)
        del z
        out = mm(a, lp.w2) + lp.b2
        h = _layer_norm(torch.relu(out), lp.ln)
    return h


def node_logits(cfg: GNNConfig, model: GIN, h: torch.Tensor) -> torch.Tensor:
    return mm(h, model.out) + model.out_b


def graph_logits(cfg: GNNConfig, model: GIN, h: torch.Tensor,
                 graph_id: torch.Tensor, n_graphs: int) -> torch.Tensor:
    """Sum-pool each graph's node rows, then classify: (n_graphs, C)."""
    pooled = torch.zeros((n_graphs, h.shape[1]), dtype=h.dtype,
                         device=h.device)
    pooled.index_add_(0, graph_id, h)
    return mm(pooled, model.out) + model.out_b


def _first_argmax(logits: torch.Tensor) -> torch.Tensor:
    """The index of each row's first maximum, as ``jnp.argmax`` gives."""
    top = torch.amax(logits, dim=-1, keepdim=True)
    cols = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(logits == top, cols, logits.shape[-1]).amin(dim=-1)


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """(logsumexp - the gold logit) per row, and whether the first argmax
    is the label."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[:, None])[:, 0]
    hit = (_first_argmax(logits) == labels).to(torch.float32)
    return lse - gold, hit


def node_loss(cfg: GNNConfig, model: GIN,
              batch: Mapping[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: x (N, F), edge_src / edge_dst (E,), labels (N,), label_mask
    (N,), optionally edge_mask (E,) -> the masked mean cross-entropy and
    accuracy."""
    h = gin_forward(cfg, model, batch["x"], batch["edge_src"],
                    batch["edge_dst"], batch.get("edge_mask"))
    logits = node_logits(cfg, model, h).to(torch.float32)
    ce, hit = _cross_entropy(logits, batch["labels"])
    m = batch["label_mask"]
    cnt = torch.clamp(torch.sum(m), min=1.0)
    loss = torch.sum(ce * m) / cnt
    acc = torch.sum(hit * m) / cnt
    return loss, {"loss": loss, "acc": acc}


def graph_loss(cfg: GNNConfig, model: GIN,
               batch: Mapping[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: x (N, F), edge_src / edge_dst (E,), graph_id (N,), labels
    (G,) -> the mean cross-entropy and accuracy over the G graphs."""
    g = batch["labels"].shape[0]
    h = gin_forward(cfg, model, batch["x"], batch["edge_src"],
                    batch["edge_dst"], batch.get("edge_mask"))
    logits = graph_logits(cfg, model, h, batch["graph_id"], g).to(
        torch.float32)
    ce, hit = _cross_entropy(logits, batch["labels"])
    loss = torch.mean(ce)
    return loss, {"loss": loss, "acc": torch.mean(hit)}
