"""RecSys models for serving: DeepFM, DLRM, SASRec and BERT4Rec, the port
of ``repro.models.recsys``.

The embedding substrate: :func:`embedding_bag` gathers and reduces
fixed-size bags, :func:`embedding_bag_ragged` offset-delimited ones
(``index_add_`` for the reference's ``segment_sum``).  The sparse fields
of DeepFM and DLRM share one stacked table of (F * V, E) rows; field f's
id i is row ``f * V + i``.  MLP weights keep the reference's (in, out)
layout (``x @ w + b``).

- **DeepFM** (``"fm"``): FM first order (a per-row weight ``fm_w`` and a
  bias), FM second order ``0.5 * ((sum_f v)^2 - sum_f v^2)`` summed over
  E, and a deep MLP over the F * E flattened embeddings; plain PyTorch,
  as the reference's is plain ``jnp``.
- **DLRM** (``"dot"``): the bottom MLP maps the dense features to an
  E-vector, which joins the F embeddings as slot 0 of a (B, F + 1, E)
  interaction input; the dot interaction (kernel 4,
  :func:`repro_torch.kernels.ops.dot_interaction`) gives its
  (F + 1) F / 2 pairs, and the top MLP maps [dense vector, pairs] to one
  logit.  Served (no gradient), the interaction input is one preallocated
  tensor: a single ``index_select`` gathers all F + 1 slots' rows into it
  (slot 0 gathers a placeholder row), and the bottom MLP's output then
  overwrites slot 0.  No concatenated copy is made: at ``retrieval_cand``
  (10^6 rows) the input alone is 6.9 GB.  Where autograd records the
  graph (training), the input is the reference's concatenation of the
  dense vector and the gathered rows, and kernel 4 runs under
  :class:`repro_torch.kernels.ops.DotInteraction`.
- **SASRec** (``"self-attn-seq"``, causal) and **BERT4Rec**
  (``"bidir-seq"``): ``n_blocks`` pre-norm blocks over item and position
  embeddings, on :func:`layers.rmsnorm` and :func:`layers.attention`; the
  item table has ``n_items + 2`` rows (pad and mask tokens).  Serving
  scores the last position's hidden state against candidate items, in
  fp32.

The losses are differentiable; ``serve_fn`` and ``retrieval_fn`` run
without a graph.  A table's gradient is dense, as the reference's
``jnp.take`` gives it.  DLRM gathers with ``index_select``, whose
backward adds into a zeroed table with atomics on a card, so its last
bits may vary from run to run; the other models gather through
:func:`layers.take` (``embedding``), whose backward sorts the ids first
and gives the same bits in every run.

An id out of range is answered as the reference's ``jnp.take`` answers
it: one in [-n, 0) counts from the end of the n-row table, and any other
gives a NaN row (:func:`layers.take`).  So a sequential model's output
is NaN where the reference's is, and a DeepFM or DLRM sample that holds
such an id scores NaN while every other sample is unchanged.  Served,
DeepFM and DLRM gather an in-bounds row for it and make the sample's
output NaN from a (B,) mask (DeepFM's logit, DLRM's dense vector, which
reaches its logit), with no pass over the gathered rows.  No gather reads
out of bounds.  A ragged bag's segment id out of range is dropped, as
``segment_sum`` drops it.

The fp32 products run in full fp32; on a CUDA device they refuse to run
while TF32 is allowed for them.
Everything runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import pytree
from repro_torch.configs.base import RecSysConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import (ParamMaker, assign_from_reference,
                                       attention, mm, reference_tensor,
                                       require_full_fp32, rmsnorm,
                                       segment_sum, spare_segment_ids, take,
                                       take_ids)


# ---------------------------------------------------------------------------
# Embedding substrate
# ---------------------------------------------------------------------------


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  combiner: str = "sum",
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """table (V, E); ids (..., M) multi-hot bags -> (..., E).  The mean of
    an empty bag (M = 0) is NaN, as the reference's."""
    vecs = take(table, ids)                                # (..., M, E)
    if weights is not None:
        vecs = vecs * weights[..., None]
    if combiner == "sum":
        return torch.sum(vecs, dim=-2)
    if combiner == "mean":
        return torch.mean(vecs, dim=-2)
    if combiner == "max":
        return torch.amax(vecs, dim=-2)
    raise ValueError(combiner)


def embedding_bag_ragged(table: torch.Tensor, flat_ids: torch.Tensor,
                         segment_ids: torch.Tensor, num_bags: int,
                         combiner: str = "sum") -> torch.Tensor:
    """Ragged bags: flat_ids (T,), segment_ids (T,) -> (num_bags, E).  An
    empty bag sums to 0, averages to 0 and has max -inf, as the
    reference's ``segment_sum`` / ``segment_max`` give; a segment id out
    of range is dropped, as theirs are."""
    if combiner not in ("sum", "mean", "max"):
        raise ValueError(combiner)
    vecs = take(table, flat_ids)
    if combiner == "max":
        seg = spare_segment_ids(segment_ids, num_bags).to(torch.int64)
        out = torch.full((num_bags + 1, table.shape[1]), -torch.inf,
                         dtype=vecs.dtype, device=vecs.device)
        return out.scatter_reduce_(0, seg[:, None].expand_as(vecs), vecs,
                                   "amax", include_self=True)[:num_bags]
    s = segment_sum(vecs, segment_ids, num_bags)
    if combiner == "sum":
        return s
    c = segment_sum(torch.ones(segment_ids.shape, dtype=vecs.dtype,
                               device=vecs.device), segment_ids, num_bags)
    return s / torch.clamp(c, min=1.0)[:, None]


class MLP(nn.Module):
    """Dense layers in the reference's (in, out) layout, ReLU between
    them and, with ``final_act``, after the last."""

    def __init__(self, dims: Sequence[int], mk: ParamMaker):
        super().__init__()
        pairs = list(zip(dims[:-1], dims[1:]))
        self.w = nn.ParameterList([mk.dense(i, o) for i, o in pairs])
        self.b = nn.ParameterList([mk.const((o,), 0.0) for _, o in pairs])

    def reference_layout(self, prefix: str):
        """The reference's ``[{"w", "b"}, ...]`` under ``prefix``."""
        return [pytree.Leaf((prefix, i, k), (f"{prefix}.{k}.{i}",))
                for i in range(len(self.w)) for k in ("w", "b")]

    def forward(self, x: torch.Tensor, final_act: bool = False):
        require_full_fp32(x, "the recsys MLPs")
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i < n - 1 or final_act:
                x = torch.relu(x)
        return x

    def load_reference(self, layers: Sequence[Mapping]) -> None:
        """Copy the reference's ``[{"w", "b"}, ...]`` layers in."""
        if len(layers) != len(self.w):
            raise ValueError(f"{len(layers)} reference layers for an MLP "
                             f"of {len(self.w)}")
        with torch.no_grad():
            for w, b, layer in zip(self.w, self.b, layers):
                w.copy_(reference_tensor(layer["w"]))
                b.copy_(reference_tensor(layer["b"]))


def _check_interaction(cfg: RecSysConfig, kinds: Tuple[str, ...],
                       model: str) -> None:
    if cfg.interaction not in kinds:
        raise ValueError(f"{model} serves the {kinds} interaction, not "
                         f"{cfg.interaction!r} ({cfg.name})")


def as_batch(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """A ``recsys_batch`` (numpy) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _flat_field_ids(cfg: RecSysConfig, sparse_ids: torch.Tensor):
    """(B, F) per-field ids -> global row ids in the stacked table (int64)."""
    offs = torch.arange(0, cfg.n_sparse * cfg.vocab_per_field,
                        cfg.vocab_per_field, dtype=torch.int64,
                        device=sparse_ids.device)
    return sparse_ids + offs[None, :]


def _served_rows(cfg: RecSysConfig, table: torch.Tensor,
                 sparse_ids: torch.Tensor):
    """(B, F) per-field ids -> (their rows in the stacked table, each in
    bounds; (B,) whether every id of the sample lies in the table, as
    ``jnp.take`` reads it).  The reference's NaN row reaches the whole
    sample's logit, so a served model gathers in-bounds rows and sets the
    other samples' output to NaN, with no pass over the gathered rows."""
    rows, ok = take_ids(_flat_field_ids(cfg, sparse_ids), table.shape[0])
    return rows, ok.all(dim=-1)


# ---------------------------------------------------------------------------
# DeepFM
# ---------------------------------------------------------------------------


class DeepFM(nn.Module):
    """DeepFM: ``table`` (F * V, E), the FM first-order ``fm_w`` (F * V,)
    and scalar ``fm_b``, and the deep ``mlp`` (F * E -> mlp -> 1).

    With a ``generator`` (a ``torch.Generator`` on ``device``'s type) the
    weights are drawn as the reference's ``init_deepfm`` draws them: table
    and ``fm_w`` N(0, 1) x 0.01, dense layers N(0, 1) / sqrt(in), zero
    biases.  Without one they are left uninitialised, to be filled by
    :func:`params_from_reference`."""

    def __init__(self, cfg: RecSysConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        _check_interaction(cfg, ("fm",), "DeepFM")
        mk = ParamMaker(dtype, resolve_device(device), generator)
        self.cfg = cfg
        f, v, e = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
        self.table = mk.normal((f * v, e), 0.01)
        self.fm_w = mk.normal((f * v,), 0.01)
        self.fm_b = mk.const((), 0.0)
        self.mlp = MLP((f * e,) + tuple(cfg.mlp) + (1,), mk)

    def reference_layout(self):
        return ([pytree.Leaf((k,), (k,)) for k in ("table", "fm_w", "fm_b")]
                + self.mlp.reference_layout("mlp"))


def init_deepfm(cfg: RecSysConfig, generator: torch.Generator, *,
                device="cuda", dtype: torch.dtype = torch.float32) -> DeepFM:
    """A DeepFM of ``cfg`` with weights drawn from ``generator``."""
    return DeepFM(cfg, generator=generator, device=device, dtype=dtype)


def deepfm_logits(cfg: RecSysConfig, model: DeepFM,
                  batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """batch: sparse_ids (B, F) -> logits (B,) fp32."""
    if torch.is_grad_enabled():
        rows = _flat_field_ids(cfg, batch["sparse_ids"])
        emb, fm_w, ok = take(model.table, rows), take(model.fm_w, rows), None
    else:
        rows, ok = _served_rows(cfg, model.table, batch["sparse_ids"])
        emb, fm_w = model.table[rows], model.fm_w[rows]    # (B, F, E)
    # FM first order
    fo = torch.sum(fm_w, dim=-1) + model.fm_b
    # FM second order: 0.5 * ((sum_f v)^2 - sum_f v^2), summed over E
    s = torch.sum(emb, dim=1)
    s2 = torch.sum(emb * emb, dim=1)
    so = 0.5 * torch.sum(s * s - s2, dim=-1)
    # deep branch
    deep = model.mlp(emb.reshape(emb.shape[0], -1))[:, 0]
    out = (fo + so + deep).to(torch.float32)
    return out if ok is None else torch.where(ok, out, float("nan"))


# ---------------------------------------------------------------------------
# DLRM
# ---------------------------------------------------------------------------


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
        _check_interaction(cfg, ("dot",), "DLRM")
        mk = ParamMaker(dtype, resolve_device(device), generator)
        self.cfg = cfg
        f, v, e = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
        self.table = mk.normal((f * v, e), 0.01)
        n_pairs = (f + 1) * f // 2
        self.bot = MLP((cfg.n_dense,) + tuple(cfg.bot_mlp), mk)
        self.top = MLP((e + n_pairs,) + tuple(cfg.top_mlp), mk)

    def reference_layout(self):
        return ([pytree.Leaf(("table",), ("table",))]
                + self.bot.reference_layout("bot")
                + self.top.reference_layout("top"))


def init_dlrm(cfg: RecSysConfig, generator: torch.Generator, *,
              device="cuda", dtype: torch.dtype = torch.float32) -> DLRM:
    """A DLRM of ``cfg`` with weights drawn from ``generator``."""
    return DLRM(cfg, generator=generator, device=device, dtype=dtype)


def interaction_input(cfg: RecSysConfig, model: DLRM,
                      batch: Mapping[str, torch.Tensor]):
    """(dense vector (B, E), the (B, F + 1, E) interaction input): slot 0
    the bottom MLP's output, slots 1..F the embeddings.  Without a graph
    it is built in one preallocated tensor (``index_select(out=)``, which
    autograd refuses); with one, as the reference builds it, by a
    concatenation.  An id out of range gathers a NaN row with a graph (the
    reference's ``jnp.take``); without one it gathers an in-bounds row and
    sets the sample's dense vector to NaN (:func:`_served_rows`), which
    carries to its logit as the reference's NaN row does."""
    ids = batch["sparse_ids"]
    if torch.is_grad_enabled():
        dense_vec = model.bot(batch["dense"].to(model.table.dtype),
                              final_act=True)
        # one index_select, as the served path gathers (its backward adds
        # into a zeroed table); a NaN row where jnp.take fills one
        rows, ok = take_ids(_flat_field_ids(cfg, ids), model.table.shape[0])
        emb = torch.where(ok[..., None], torch.index_select(
            model.table, 0, rows.reshape(-1)).reshape(
                rows.shape + (cfg.embed_dim,)), float("nan"))
        return dense_vec, torch.cat([dense_vec[:, None, :], emb], dim=1)
    b, f = ids.shape
    e = cfg.embed_dim
    rows, ok = _served_rows(cfg, model.table, ids)
    slots = torch.zeros((b, f + 1), dtype=torch.int64, device=ids.device)
    slots[:, 1:] = rows
    x = torch.empty((b, f + 1, e), dtype=model.table.dtype,
                    device=model.table.device)
    torch.index_select(model.table, 0, slots.view(-1),
                       out=x.view(b * (f + 1), e))
    dense_vec = torch.where(ok[:, None], model.bot(
        batch["dense"].to(model.table.dtype), final_act=True), float("nan"))
    x[:, 0] = dense_vec
    return dense_vec, x


def dlrm_logits(cfg: RecSysConfig, model: DLRM,
                batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """batch: dense (B, n_dense), sparse_ids (B, F) -> logits (B,) fp32."""
    dense_vec, x = interaction_input(cfg, model, batch)
    inter = ops.dot_interaction(x)                         # (B, (F+1)F/2)
    del x
    top_in = torch.cat([dense_vec, inter.to(dense_vec.dtype)], dim=-1)
    del inter
    return model.top(top_in)[:, 0].to(torch.float32)


# ---------------------------------------------------------------------------
# Sequential: SASRec (causal) / BERT4Rec (bidirectional)
# ---------------------------------------------------------------------------


class SeqBlock(nn.Module):
    """One pre-norm block: ``ln1``, ``wq`` / ``wk`` / ``wv`` / ``wo``
    (E, E), ``ln2``, ``w1`` (E, 4E) / ``b1``, ``w2`` (4E, E) / ``b2``."""

    def __init__(self, e: int, mk: ParamMaker):
        super().__init__()
        self.ln1, self.ln2 = mk.const((e,), 1.0), mk.const((e,), 1.0)
        self.wq, self.wk, self.wv, self.wo = (mk.dense(e, e)
                                              for _ in range(4))
        self.w1, self.b1 = mk.dense(e, 4 * e), mk.const((4 * e,), 0.0)
        self.w2, self.b2 = mk.dense(4 * e, e), mk.const((e,), 0.0)


class SeqRec(nn.Module):
    """SASRec / BERT4Rec: ``item_emb`` (n_items + 2, E) (the pad and mask
    tokens are the last two rows), ``pos_emb`` (seq_len, E), ``blocks``
    (``n_blocks`` :class:`SeqBlock`) and ``final_ln``.

    With a ``generator`` the weights are drawn as the reference's
    ``init_seqrec`` draws them: both embeddings N(0, 1) x 0.02, dense
    layers N(0, 1) / sqrt(in), norms 1 and biases 0."""

    def __init__(self, cfg: RecSysConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        _check_interaction(cfg, ("self-attn-seq", "bidir-seq"), "SeqRec")
        mk = ParamMaker(dtype, resolve_device(device), generator)
        self.cfg = cfg
        e = cfg.embed_dim
        self.item_emb = mk.normal((cfg.n_items + 2, e), 0.02)
        self.pos_emb = mk.normal((cfg.seq_len, e), 0.02)
        self.final_ln = mk.const((e,), 1.0)
        self.blocks = nn.ModuleList([SeqBlock(e, mk)
                                     for _ in range(cfg.n_blocks)])


def init_seqrec(cfg: RecSysConfig, generator: torch.Generator, *,
                device="cuda", dtype: torch.dtype = torch.float32) -> SeqRec:
    """A SASRec / BERT4Rec of ``cfg`` with weights drawn from
    ``generator``."""
    return SeqRec(cfg, generator=generator, device=device, dtype=dtype)


def _seq_encode(cfg: RecSysConfig, model: SeqRec, seq: torch.Tensor,
                causal: bool) -> torch.Tensor:
    """seq (B, S) item ids -> hidden (B, S, E).  The FFN's bias and ReLU
    run in place on fresh tensors, and without a graph so do the residual
    adds: the reference's arithmetic, in less memory (autograd keeps the
    residual stream for its backward)."""
    inplace = not torch.is_grad_enabled()

    def add(x, y):
        return x.add_(y) if inplace else x + y

    b, s = seq.shape
    e, h = cfg.embed_dim, cfg.n_heads
    dh = e // h
    x = take(model.item_emb, seq) + model.pos_emb[None, :s]
    require_full_fp32(x, "the sequential recommenders")
    for blk in model.blocks:
        xn = rmsnorm(x, blk.ln1)
        q = mm(xn, blk.wq).reshape(b, s, h, dh)
        k = mm(xn, blk.wk).reshape(b, s, h, dh)
        v = mm(xn, blk.wv).reshape(b, s, h, dh)
        del xn
        o = attention(q, k, v, causal=causal, q_chunk=0).reshape(b, s, e)
        del q, k, v
        x = add(x, mm(o, blk.wo))
        del o
        xn = rmsnorm(x, blk.ln2)
        ff = mm(xn, blk.w1)
        del xn
        ff += blk.b1
        ff.relu_()
        x = add(x, mm(ff, blk.w2))
        del ff
        x = add(x, blk.b2)
    return rmsnorm(x, model.final_ln)


def _causal(cfg: RecSysConfig) -> bool:
    return cfg.interaction == "self-attn-seq"


def seqrec_scores(cfg: RecSysConfig, model: SeqRec, hidden: torch.Tensor,
                  item_ids: torch.Tensor) -> torch.Tensor:
    """Score hidden (..., E) against item_ids (..., C) -> (..., C), fp32."""
    cand = take(model.item_emb, item_ids)
    return torch.einsum("...e,...ce->...c", hidden.to(torch.float32),
                        cand.to(torch.float32))


def seqrec_loss(cfg: RecSysConfig, model: SeqRec,
                batch: Mapping[str, torch.Tensor]):
    """Sampled BCE (SASRec-style): batch has seq, pos, neg (B, S), mask
    (B, S).  For BERT4Rec the ``seq`` already holds [MASK] tokens at masked
    positions and pos / neg are the original / negative items there."""
    h = _seq_encode(cfg, model, batch["seq"], causal=_causal(cfg))
    h = h.to(torch.float32)
    pe = take(model.item_emb, batch["pos"]).to(torch.float32)
    ne = take(model.item_emb, batch["neg"]).to(torch.float32)
    ps = torch.sum(h * pe, dim=-1)
    ns = torch.sum(h * ne, dim=-1)
    m = batch["mask"].to(torch.float32)
    logsig = torch.nn.functional.logsigmoid
    loss = -(logsig(ps) + logsig(-ns)) * m
    loss = torch.sum(loss) / torch.clamp(torch.sum(m), min=1.0)
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# Unified interface
# ---------------------------------------------------------------------------


def init_params(cfg: RecSysConfig, generator: torch.Generator, *,
                device="cuda", dtype: torch.dtype = torch.float32):
    """The model of ``cfg``'s interaction, weights drawn from
    ``generator``."""
    if cfg.interaction == "fm":
        return init_deepfm(cfg, generator, device=device, dtype=dtype)
    if cfg.interaction == "dot":
        return init_dlrm(cfg, generator, device=device, dtype=dtype)
    return init_seqrec(cfg, generator, device=device, dtype=dtype)


def params_from_reference(cfg: RecSysConfig, params: Mapping,
                          device="cuda"):
    """The reference's ``init_deepfm``, ``init_dlrm`` or ``init_seqrec``
    pytree (as numpy arrays) as the matching module on ``device``, in the
    dtype of its table."""
    if cfg.interaction == "fm":
        model = DeepFM(cfg, device=device,
                       dtype=reference_tensor(params["table"]).dtype)
        model.mlp.load_reference(params["mlp"])
        assign_from_reference(model, {k: params[k] for k in
                                      ("table", "fm_w", "fm_b")},
                              recurse=False)
        return model
    if cfg.interaction == "dot":
        model = DLRM(cfg, device=device,
                     dtype=reference_tensor(params["table"]).dtype)
        model.bot.load_reference(params["bot"])
        model.top.load_reference(params["top"])
        assign_from_reference(model, {"table": params["table"]},
                              recurse=False)
        return model
    model = SeqRec(cfg, device=device,
                   dtype=reference_tensor(params["item_emb"]).dtype)
    tree = dict(params, blocks={str(i): b
                                for i, b in enumerate(params["blocks"])})
    assign_from_reference(model, tree)
    return model


def params_to_reference(cfg: RecSysConfig, model):
    """The inverse of :func:`params_from_reference`: the reference's
    ``init_deepfm``, ``init_dlrm`` or ``init_seqrec`` pytree of the
    module's weights, as detached tensors that share their storage."""
    return pytree.module_tree(model)


def param_specs(cfg: RecSysConfig, params) -> Dict:
    """Tables row-sharded over "rows" -> model axis; MLPs replicated.  The
    reference's tree of logical axes, over ``params`` in the reference's
    layout (:func:`params_to_reference`; a module is taken to it)."""
    if isinstance(params, nn.Module):
        params = params_to_reference(cfg, params)

    def spec(path_key, x):
        if path_key in ("table", "fm_w", "item_emb"):
            return ("rows",) + tuple([None] * (x.dim() - 1))
        return tuple([None] * x.dim())

    def rec(tree, name=""):
        if isinstance(tree, dict):
            return {k: rec(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [rec(v, name) for v in tree]
        return spec(name, tree)

    return rec(params)


def pointwise_loss(cfg: RecSysConfig, model,
                   batch: Mapping[str, torch.Tensor]):
    """BCE for DeepFM / DLRM: batch adds labels (B,)."""
    logits = (deepfm_logits if cfg.interaction == "fm" else dlrm_logits)(
        cfg, model, batch)
    y = batch["labels"].to(torch.float32)
    logsig = torch.nn.functional.logsigmoid
    loss = torch.mean(-(y * logsig(logits) + (1 - y) * logsig(-logits)))
    return loss, {"loss": loss}


def loss_fn(cfg: RecSysConfig, model, batch: Mapping[str, torch.Tensor]):
    """The training loss: (loss, {"loss": loss}), differentiable."""
    if cfg.interaction in ("fm", "dot"):
        return pointwise_loss(cfg, model, batch)
    return seqrec_loss(cfg, model, batch)


@torch.no_grad()
def serve_fn(cfg: RecSysConfig, model,
             batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Online and bulk inference: click probabilities (B,) for DeepFM and
    DLRM; for the sequential models the last position's scores against
    ``batch["candidates"]`` (B, C) -> (B, C)."""
    if cfg.interaction == "fm":
        return torch.sigmoid(deepfm_logits(cfg, model, batch))
    if cfg.interaction == "dot":
        return torch.sigmoid(dlrm_logits(cfg, model, batch))
    h = _seq_encode(cfg, model, batch["seq"], causal=_causal(cfg))[:, -1]
    return seqrec_scores(cfg, model, h, batch["candidates"])


@torch.no_grad()
def retrieval_fn(cfg: RecSysConfig, model,
                 batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """One query scored against C candidates.  DeepFM and DLRM run
    candidate-major: the batch holds the C candidate rows (user features
    broadcast), and the result is their logits (C,).  The sequential
    models encode ``seq`` (1, S) once and score its last position against
    ``candidates`` (C,) -> (1, C), one (1, E) x (E, C) product."""
    if cfg.interaction in ("fm", "dot"):
        return (deepfm_logits if cfg.interaction == "fm" else dlrm_logits)(
            cfg, model, batch)
    h = _seq_encode(cfg, model, batch["seq"], causal=_causal(cfg))[:, -1]
    ce = take(model.item_emb, batch["candidates"])               # (C, E)
    return torch.einsum("be,ce->bc", h.to(torch.float32),
                        ce.to(torch.float32))
