"""DLRM (dot interaction) for serving: the DLRM part of
``repro.models.recsys``.

The sparse fields share one stacked table of (F * V, E) rows; field f's id
i is row ``f * V + i``.  The bottom MLP maps the dense features to an
E-vector, which joins the F embeddings as slot 0 of a (B, F + 1, E)
interaction input; the dot interaction (kernel 4,
:func:`repro_torch.kernels.ops.dot_interaction`) gives its
(F + 1) F / 2 pairs, and the top MLP maps [dense vector, pairs] to one
logit.  MLP weights keep the reference's (in, out) layout (``x @ w + b``).

The interaction input is one preallocated tensor: a single
``index_select`` gathers all F + 1 slots' rows into it (slot 0 gathers a
placeholder row), and the bottom MLP's output then overwrites slot 0.  No
concatenated copy is made: at ``retrieval_cand`` (10^6 rows) the input
alone is 6.9 GB.

Ids must lie in [0, V): ``index_select`` raises a device assert on an id
out of range, where the reference's ``jnp.take`` fills it
(``recsys_batch`` never draws one).  The fp32 MLPs run as ``torch``
matrix products in full fp32; on a CUDA device they refuse to run while
TF32 is allowed for them.  Everything runs on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import RecSysConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, reference_tensor

_NOT_PORTED = ("the {} interaction ({}) is not ported yet: DeepFM, SASRec "
               "and BERT4Rec wait for the side models, ROADMAP.md §1")


def _require_dot(cfg: RecSysConfig) -> None:
    if cfg.interaction != "dot":
        raise NotImplementedError(_NOT_PORTED.format(repr(cfg.interaction),
                                                     cfg.name))


class MLP(nn.Module):
    """Dense layers in the reference's (in, out) layout, ReLU between
    them and, with ``final_act``, after the last."""

    def __init__(self, dims: Sequence[int], *, device, dtype,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        pairs = list(zip(dims[:-1], dims[1:]))
        if generator is None:
            ws = [torch.empty((i, o), dtype=dtype, device=device)
                  for i, o in pairs]
        else:
            ws = [dense_init(generator, i, o, dtype, device) for i, o in pairs]
        self.w = nn.ParameterList([nn.Parameter(w, requires_grad=False)
                                   for w in ws])
        self.b = nn.ParameterList([
            nn.Parameter(torch.zeros((o,), dtype=dtype, device=device),
                         requires_grad=False) for _, o in pairs])

    def forward(self, x: torch.Tensor, final_act: bool = False):
        if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32 or
                          torch.get_float32_matmul_precision() != "highest"):
            raise RuntimeError(
                "the DLRM MLPs run in full fp32, as the reference does: set "
                "torch.backends.cuda.matmul.allow_tf32 = False and "
                "torch.set_float32_matmul_precision('highest')")
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i < n - 1 or final_act:
                x = torch.relu(x)
        return x


class DLRM(nn.Module):
    """DLRM with dot interaction: ``table`` (F * V, E), ``bot`` (n_dense ->
    bot_mlp) and ``top`` (E + (F + 1) F / 2 -> top_mlp).

    With a ``generator`` (a ``torch.Generator`` on ``device``'s type) the
    weights are drawn as the reference's ``init_dlrm`` draws them: table
    N(0, 1) x 0.01, dense layers N(0, 1) / sqrt(in), zero biases.  Without
    one they are left uninitialised, to be filled by
    :func:`params_from_reference`."""

    def __init__(self, cfg: RecSysConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        _require_dot(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        f, v, e = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
        table = torch.empty((f * v, e), dtype=torch.float32, device=dev)
        if generator is not None:
            table.normal_(generator=generator).mul_(0.01)
        self.table = nn.Parameter(table.to(dtype), requires_grad=False)
        n_pairs = (f + 1) * f // 2
        self.bot = MLP((cfg.n_dense,) + tuple(cfg.bot_mlp), device=dev,
                       dtype=dtype, generator=generator)
        self.top = MLP((e + n_pairs,) + tuple(cfg.top_mlp), device=dev,
                       dtype=dtype, generator=generator)


def init_params(cfg: RecSysConfig, generator: torch.Generator, *,
                device="cuda", dtype: torch.dtype = torch.float32) -> DLRM:
    """A DLRM of ``cfg`` with weights drawn from ``generator``."""
    return DLRM(cfg, generator=generator, device=device, dtype=dtype)


def params_from_reference(cfg: RecSysConfig, params: Mapping,
                          device="cuda") -> DLRM:
    """The reference's ``init_dlrm`` pytree (``{"table", "bot": [{"w",
    "b"}, ...], "top": [...]}``, as numpy arrays) as a :class:`DLRM` on
    ``device``, in the table's dtype."""
    table = reference_tensor(params["table"])
    model = DLRM(cfg, device=device, dtype=table.dtype)
    with torch.no_grad():
        model.table.copy_(table)
        for mlp, layers in ((model.bot, params["bot"]),
                            (model.top, params["top"])):
            if len(layers) != len(mlp.w):
                raise ValueError(f"{len(layers)} reference layers for an MLP "
                                 f"of {len(mlp.w)}")
            for w, b, layer in zip(mlp.w, mlp.b, layers):
                w.copy_(reference_tensor(layer["w"]))
                b.copy_(reference_tensor(layer["b"]))
    return model


def as_batch(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """A ``recsys_batch`` (numpy) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _flat_field_ids(cfg: RecSysConfig, sparse_ids: torch.Tensor):
    """(B, F) per-field ids -> global row ids in the stacked table (int64)."""
    offs = torch.arange(cfg.n_sparse, dtype=torch.int64,
                        device=sparse_ids.device) * cfg.vocab_per_field
    return sparse_ids.to(torch.int64) + offs[None, :]


def interaction_input(cfg: RecSysConfig, model: DLRM,
                      batch: Mapping[str, torch.Tensor]):
    """(dense vector (B, E), the (B, F + 1, E) interaction input), built in
    one preallocated tensor: slot 0 the bottom MLP's output, slots 1..F the
    embeddings."""
    ids = batch["sparse_ids"]
    b, f = ids.shape
    e = cfg.embed_dim
    rows = torch.zeros((b, f + 1), dtype=torch.int64, device=ids.device)
    rows[:, 1:] = _flat_field_ids(cfg, ids)
    x = torch.empty((b, f + 1, e), dtype=model.table.dtype,
                    device=model.table.device)
    torch.index_select(model.table, 0, rows.view(-1), out=x.view(b * (f + 1), e))
    dense_vec = model.bot(batch["dense"].to(model.table.dtype), final_act=True)
    x[:, 0] = dense_vec
    return dense_vec, x


@torch.no_grad()
def dlrm_logits(cfg: RecSysConfig, model: DLRM,
                batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """batch: dense (B, n_dense), sparse_ids (B, F) -> logits (B,) fp32."""
    _require_dot(cfg)
    dense_vec, x = interaction_input(cfg, model, batch)
    inter = ops.dot_interaction(x)                         # (B, (F+1)F/2)
    del x
    top_in = torch.cat([dense_vec, inter.to(dense_vec.dtype)], dim=-1)
    del inter
    return model.top(top_in)[:, 0].to(torch.float32)


def serve_fn(cfg: RecSysConfig, model: DLRM,
             batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Online and bulk inference: click probabilities (B,)."""
    return torch.sigmoid(dlrm_logits(cfg, model, batch))


def retrieval_fn(cfg: RecSysConfig, model: DLRM,
                 batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """One query scored against C candidates, candidate-major: the batch
    holds the C candidate rows (user features broadcast), and the result
    is their logits (C,)."""
    return dlrm_logits(cfg, model, batch)
