"""Dry-run cells: one per (architecture x input shape), the port of
``repro.launch.cells``.

A *cell* is everything needed to run one step of one architecture at one
input shape:

  * the step function, the port's entry point (``make_train_step`` over
    the model's loss, ``prefill`` / ``decode_step``, ``serve_fn`` /
    ``retrieval_fn``, ``bfs_construct(_batch)``, ``ingest`` then a query),
  * its arguments: ``meta`` tensors (PyTorch's placeholders, which
    allocate nothing) in place of the reference's ``ShapeDtypeStruct``
    stand-ins, the model built by the port's own ``init_*`` on ``meta``;
    or, with ``device=`` a real device, seeded random values of the same
    shapes drawn there (ids inside their ranges; the co-occurrence index,
    its new documents and its seeds from the CSL corpus model of
    ``data/corpus.py``) and a seeded model,
  * in/out shardings resolved from the logical-axis rule table,
  * donation hints,
  * MODEL_FLOPS and MODEL_BYTES, the reference's arithmetic.

``plan_cell(arch, shape_name)`` must be called inside an active
``sharding.axis_rules(mesh)`` context — that is where logical axes bind
to physical mesh axes.  A model argument is an ``nn.Module``; its
shardings are in the reference's layout (``params_to_reference``), as
are the optimizer state's.  The co-occurrence index is a ``PackedIndex``
whose bitmaps are int32 bit patterns (the reference's uint32) and whose
``n_docs`` is an int32 scalar tensor, as the reference's is.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.configs.base import (
    CoocConfig,
    GNNConfig,
    LMConfig,
    RecSysConfig,
    ShapeSpec,
)
from repro_torch.core import bfs_construct, bfs_construct_batch, ingest, \
    traversal_construct_dense
from repro_torch.core.inverted_index import PackedIndex, incidence_dense
from repro_torch.data.sampler import subgraph_sizes
from repro_torch.device import resolve_device
from repro_torch.launch.sharding import constrain, named_sharding, \
    sharding_tree
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.step import make_train_step


def sds(shape, dtype) -> torch.Tensor:
    """A stand-in: a ``meta`` tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


class _Inputs:
    """The cell's argument leaves: stand-ins on ``meta``; elsewhere seeded
    random values drawn on the device: integers in [0, ``high``) where a
    range is given (ids, labels, 0/1 masks), else N(0, 1)."""

    def __init__(self, device, seed: int):
        self.device = resolve_device(device)
        self.meta = self.device.type == "meta"
        gen_dev = "cpu" if self.meta else self.device
        self.gen = torch.Generator(device=gen_dev).manual_seed(seed)

    def __call__(self, shape, dtype, high: Optional[int] = None):
        shape = tuple(shape)
        if self.meta:
            return sds(shape, dtype)
        if high is not None:
            draw = torch.uint8 if dtype == torch.bool else dtype
            return torch.randint(0, high, shape, generator=self.gen,
                                 device=self.device, dtype=draw).to(dtype)
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=dtype)


@dataclasses.dataclass
class CellPlan:
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: Tuple[Any, ...]            # the step's arguments (meta stand-ins)
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    model_flops: float               # 6ND-style useful-FLOPs estimate (global)
    model_bytes: float = 0.0         # mandatory bytes for memory-bound work (global)
    note: str = ""
    # where ``fn`` needs the data's values on meta: a program on the same
    # arguments that does not, whose live bytes bound ``fn``'s and whose
    # FLOPs and kernel counts are ``fn``'s (the dry-run's fit rule and
    # FLOP gate read it)
    bound_fn: Optional[Callable] = None


def arg_tree(x) -> Any:
    """An argument as a tree of tensors in the reference's layout: a module
    as its ``params_to_reference`` tree (of ``meta`` stand-ins: a stack of
    layers is never copied), a ``PackedIndex`` as its three fields."""
    if isinstance(x, nn.Module):
        return pytree.module_tree(x, {n: p.detach().to("meta")
                                      for n, p in x.named_parameters()})
    if isinstance(x, PackedIndex):
        return list(x)
    if isinstance(x, dict):
        return {k: arg_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [arg_tree(v) for v in x]
    return x


def _tree_bytes(tree) -> float:
    return float(sum(math.prod(l.shape) * l.element_size()
                     for l in pytree.leaves(arg_tree(tree))))


def _logical_shardings(logical_tree, shape_tree):
    return sharding_tree(logical_tree, shape_tree)


def _batch_logical(batch_shapes: Dict) -> Dict:
    """Default: every batch leaf shards its leading dim over "batch"."""
    return {k: ("batch",) + (None,) * (s.dim() - 1)
            for k, s in batch_shapes.items()}


def _h_eff(cfg: LMConfig) -> float:
    return cfg.n_heads * (cfg.head_dim if not cfg.mla
                          else (cfg.qk_nope_dim + cfg.qk_rope_dim
                                + cfg.v_head_dim) / 2)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm_model(cfg: LMConfig, mk: _Inputs):
    return T.init_params(cfg, mk.gen, device=mk.device)


def _lm_train_cell(arch: str, cfg: LMConfig, spec: ShapeSpec,
                   mk: _Inputs) -> CellPlan:
    from repro_torch.configs import replace
    from repro_torch.launch.flags import unroll_scans
    if unroll_scans() and cfg.microbatches > 1:
        # the reference's unroll mode: grad accumulation only repeats the
        # same FLOPs and bytes over the microbatches
        cfg = replace(cfg, microbatches=1)
    b, s = spec["global_batch"], spec["seq_len"]
    opt = make_optimizer(cfg)
    step = make_train_step(cfg, lambda m, bt: T.loss_fn(cfg, m, bt), opt)

    model = _lm_model(cfg, mk)
    params = arg_tree(model)
    opt_s = opt.init(T.params_to_reference(cfg, model))
    batch_s = {
        "tokens": mk((b, s), torch.int32, cfg.vocab_size),
        "labels": mk((b, s), torch.int32, cfg.vocab_size),
        "mask": mk((b, s), torch.float32, 2),
    }
    pspec = T.param_specs(cfg)
    psh = _logical_shardings(pspec, params)
    osh = _logical_shardings(opt.state_specs(pspec), opt_s)
    bsh = _logical_shardings(_batch_logical(batch_s), batch_s)

    flops = 6.0 * cfg.n_active_params() * (b * s)
    # attention quadratic term (causal halves the score matmuls)
    flops += 3 * 2.0 * cfg.n_layers * b * s * s * _h_eff(cfg)

    return CellPlan(arch, spec.name, spec.kind, step,
                    (model, opt_s, batch_s), (psh, osh, bsh),
                    (psh, osh, None), (0, 1), flops)


def _cache_shapes(cfg: LMConfig, b: int, s: int, dtype) -> Dict:
    hkv, cw = T.kv_cache_dims(cfg)
    return {"kv": sds((cfg.n_layers, b, s, hkv, cw), dtype),
            "length": sds((b,), torch.int32)}


def _lm_prefill_cell(arch: str, cfg: LMConfig, spec: ShapeSpec,
                     mk: _Inputs) -> CellPlan:
    b, s = spec["global_batch"], spec["seq_len"]
    fn = functools.partial(T.prefill, cfg)
    model = _lm_model(cfg, mk)
    params = arg_tree(model)
    tokens_s = mk((b, s), torch.int32, cfg.vocab_size)
    psh = _logical_shardings(T.param_specs(cfg), params)
    tsh = _logical_shardings(("batch", None), tokens_s)

    out_s = (sds((b, cfg.padded_vocab), torch.float32),
             _cache_shapes(cfg, b, s, model.embed.dtype))
    cache_l = T.cache_specs(cfg, long_context=False)
    out_l = (tuple([None, "vocab"]), cache_l)  # logits (B,Vp), cache tree
    osh = _logical_shardings(out_l, out_s)

    flops = 2.0 * cfg.n_active_params() * (b * s)
    flops += 2.0 * cfg.n_layers * b * s * s * _h_eff(cfg)
    return CellPlan(arch, spec.name, spec.kind, fn, (model, tokens_s),
                    (psh, tsh), osh, (), flops)


def _lm_decode_cell(arch: str, cfg: LMConfig, spec: ShapeSpec,
                    mk: _Inputs) -> CellPlan:
    b, s = spec["global_batch"], spec["seq_len"]
    long_ctx = s >= 262144
    fn = functools.partial(T.decode_step, cfg)
    # bf16 is the production KV dtype; REPRO_CACHE_DTYPE=float32 is the
    # reference's sensitivity probe
    cache_dt = getattr(torch, os.environ.get("REPRO_CACHE_DTYPE",
                                             "bfloat16"))
    # FSDP is a training memory optimisation: serving keeps params
    # TP-sharded on "model" and replicated over "data"
    if os.environ.get("REPRO_DECODE_FSDP", "0") != "1":
        from repro_torch.configs import replace
        cfg = replace(cfg, fsdp=False)
    model = _lm_model(cfg, mk)
    params = arg_tree(model)
    hkv, cw = T.kv_cache_dims(cfg)
    if mk.meta:
        cache_s = _cache_shapes(cfg, b, s, cache_dt)
    else:
        # every row at the cache's last slot: the step reads all of it
        cache_s = {"kv": mk((cfg.n_layers, b, s, hkv, cw), cache_dt),
                   "length": torch.full((b,), s - 1, dtype=torch.int32,
                                        device=mk.device)}
    token_s = mk((b,), torch.int32, cfg.vocab_size)
    psh = _logical_shardings(T.param_specs(cfg), params)
    csh = _logical_shardings(T.cache_specs(cfg, long_context=long_ctx),
                             cache_s)
    tsh = _logical_shardings(("batch",), token_s)

    out_s = (sds((b, cfg.padded_vocab), torch.float32), cache_s)
    osh = _logical_shardings(((None, "vocab"),
                              T.cache_specs(cfg, long_context=long_ctx)),
                             out_s)

    flops = 2.0 * cfg.n_active_params() * b
    flops += 2.0 * 2.0 * cfg.n_layers * b * cfg.n_heads * s * (cw / 2)  # attn vs cache
    # decode is memory-bound: one pass over active params + the KV cache
    mbytes = 2.0 * cfg.n_active_params() + _tree_bytes(cache_s["kv"])
    return CellPlan(arch, spec.name, spec.kind, fn,
                    (model, cache_s, token_s), (psh, csh, tsh), osh,
                    (1,), flops, mbytes,
                    note="long-context decode: KV seq-sharded" if long_ctx else "")


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------


def _recsys_batch_shapes(cfg: RecSysConfig, batch: int, train: bool,
                         mk: _Inputs) -> Dict:
    if cfg.interaction in ("fm", "dot"):
        out = {"sparse_ids": mk((batch, cfg.n_sparse), torch.int32,
                                cfg.vocab_per_field)}
        if cfg.n_dense:
            out["dense"] = mk((batch, cfg.n_dense), torch.float32)
        if train:
            out["labels"] = mk((batch,), torch.int32, 2)
        return out
    s, n = cfg.seq_len, cfg.n_items
    if train:
        return {"seq": mk((batch, s), torch.int32, n),
                "pos": mk((batch, s), torch.int32, n),
                "neg": mk((batch, s), torch.int32, n),
                "mask": mk((batch, s), torch.float32, 2)}
    return {"seq": mk((batch, s), torch.int32, n),
            "candidates": mk((batch, 100), torch.int32, n)}


def _recsys_model_flops(cfg: RecSysConfig, batch: int, train: bool) -> float:
    mult = 3.0 if train else 1.0
    e = cfg.embed_dim
    if cfg.interaction == "fm":
        f = cfg.n_sparse
        mlp = 0
        dims = (f * e,) + tuple(cfg.mlp) + (1,)
        for i in range(len(dims) - 1):
            mlp += 2 * dims[i] * dims[i + 1]
        return mult * batch * (mlp + 4 * f * e)
    if cfg.interaction == "dot":
        f = cfg.n_sparse + 1
        mlp = 0
        bdims = (cfg.n_dense,) + tuple(cfg.bot_mlp)
        tdims = (e + f * (f - 1) // 2,) + tuple(cfg.top_mlp)
        for dims in (bdims, tdims):
            for i in range(len(dims) - 1):
                mlp += 2 * dims[i] * dims[i + 1]
        return mult * batch * (mlp + 2 * f * f * e)
    # sequential: n_blocks transformer blocks over seq_len
    s = cfg.seq_len
    per_tok = cfg.n_blocks * (2 * 4 * e * e + 2 * 2 * e * 4 * e)
    attn = cfg.n_blocks * 2 * 2 * s * s * e
    return mult * batch * (s * per_tok) + mult * batch * attn


def _recsys_cell(arch: str, cfg: RecSysConfig, spec: ShapeSpec,
                 mk: _Inputs) -> CellPlan:
    model = R.init_params(cfg, mk.gen, device=mk.device)
    params = arg_tree(model)
    pspec = R.param_specs(cfg, params)
    psh = _logical_shardings(pspec, params)

    if spec.kind == "train":
        b = spec["batch"]
        opt = make_optimizer(cfg)
        step = make_train_step(cfg, lambda m, bt: R.loss_fn(cfg, m, bt), opt)
        opt_s = opt.init(R.params_to_reference(cfg, model))
        osh = _logical_shardings(opt.state_specs(pspec), opt_s)
        batch_s = _recsys_batch_shapes(cfg, b, True, mk)
        bsh = _logical_shardings(_batch_logical(batch_s), batch_s)
        flops = _recsys_model_flops(cfg, b, train=True)
        # embedding gather+scatter traffic dominates: fwd gather + bwd
        # grad write + optimizer touch of the touched rows
        e = cfg.embed_dim
        bag = cfg.n_sparse if cfg.interaction in ("fm", "dot") else 3 * cfg.seq_len
        mbytes = 3.0 * b * bag * e * 4
        return CellPlan(arch, spec.name, spec.kind, step,
                        (model, opt_s, batch_s), (psh, osh, bsh),
                        (psh, osh, None), (0, 1), flops, mbytes)

    if spec.kind == "serve":
        b = spec["batch"]
        fn = functools.partial(R.serve_fn, cfg)
        batch_s = _recsys_batch_shapes(cfg, b, False, mk)
        bsh = _logical_shardings(_batch_logical(batch_s), batch_s)
        flops = _recsys_model_flops(cfg, b, train=False)
        e = cfg.embed_dim
        bag = cfg.n_sparse if cfg.interaction in ("fm", "dot") else cfg.seq_len
        mbytes = 1.0 * b * bag * e * 4
        return CellPlan(arch, spec.name, spec.kind, fn, (model, batch_s),
                        (psh, bsh), None, (), flops, mbytes)

    # retrieval: one query scored against n_candidates
    c = spec["n_candidates"]
    fn = functools.partial(R.retrieval_fn, cfg)
    if cfg.interaction in ("fm", "dot"):
        batch_s = _recsys_batch_shapes(cfg, c, False, mk)
        cand_l = {k: ("cand",) + (None,) * (s_.dim() - 1)
                  for k, s_ in batch_s.items()}
        bsh = _logical_shardings(cand_l, batch_s)
        flops = _recsys_model_flops(cfg, c, train=False)
    else:
        batch_s = {"seq": mk((1, cfg.seq_len), torch.int32, cfg.n_items),
                   "candidates": mk((c,), torch.int32, cfg.n_items)}
        bsh = _logical_shardings({"seq": (None, None), "candidates": ("cand",)},
                                 batch_s)
        flops = (_recsys_model_flops(cfg, 1, train=False)
                 + 2.0 * c * cfg.embed_dim)
    bag = cfg.n_sparse if cfg.interaction in ("fm", "dot") else 1
    mbytes = 1.0 * c * bag * cfg.embed_dim * 4
    return CellPlan(arch, spec.name, spec.kind, fn, (model, batch_s),
                    (psh, bsh), None, (), flops, mbytes)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def _gnn_batch_shapes(spec: ShapeSpec, mk: _Inputs) -> Tuple[Dict, str, int]:
    """Returns (batch shapes, loss kind, n_edges_effective)."""
    d = spec.dims
    f32, i32 = torch.float32, torch.int32
    if spec.name == "minibatch_lg":
        n_max, e_max = subgraph_sizes(d["batch_nodes"], (d["fanout0"], d["fanout1"]))
        shapes = {
            "x": mk((n_max, d["d_feat"]), f32),
            "edge_src": mk((e_max,), i32, n_max),
            "edge_dst": mk((e_max,), i32, n_max),
            "edge_mask": mk((e_max,), f32, 2),
            "labels": mk((n_max,), i32, d["n_classes"]),
            "label_mask": mk((n_max,), f32, 2),
        }
        return shapes, "node", e_max
    if spec.name == "molecule":
        n = d["batch"] * d["n_nodes"]
        e = d["batch"] * d["n_edges"]
        shapes = {
            "x": mk((n, d["d_feat"]), f32),
            "edge_src": mk((e,), i32, n),
            "edge_dst": mk((e,), i32, n),
            "graph_id": mk((n,), i32, d["batch"]),
            "labels": mk((d["batch"],), i32, d["n_classes"]),
        }
        return shapes, "graph", e
    n = d["n_nodes"]
    shapes = {
        "x": mk((n, d["d_feat"]), f32),
        "edge_src": mk((d["n_edges"],), i32, n),
        "edge_dst": mk((d["n_edges"],), i32, n),
        "labels": mk((n,), i32, d["n_classes"]),
        "label_mask": mk((n,), f32, 2),
    }
    return shapes, "node", d["n_edges"]


def _gnn_cell(arch: str, cfg: GNNConfig, spec: ShapeSpec,
              mk: _Inputs) -> CellPlan:
    batch_s, loss_kind, n_edges = _gnn_batch_shapes(spec, mk)
    d_feat = batch_s["x"].shape[1]
    n_classes = spec.dims["n_classes"]
    n_nodes = batch_s["x"].shape[0]

    model = G.init_gin(cfg, mk.gen, d_feat, n_classes, device=mk.device)
    params = arg_tree(model)
    pspec = G.param_specs(cfg, params)
    psh = _logical_shardings(pspec, params)

    loss = G.node_loss if loss_kind == "node" else G.graph_loss
    opt = make_optimizer(cfg)
    step = make_train_step(cfg, lambda m, bt: loss(cfg, m, bt), opt)
    opt_s = opt.init(G.params_to_reference(cfg, model))
    osh = _logical_shardings(opt.state_specs(pspec), opt_s)

    # edges shard over (pod, data); node tensors replicated
    def leaf_logical(k, s_):
        if k.startswith("edge"):
            return ("edges",)
        return tuple([None] * s_.dim())

    bl = {k: leaf_logical(k, v) for k, v in batch_s.items()}
    bsh = _logical_shardings(bl, batch_s)

    d_h = cfg.d_hidden
    flops = 3.0 * (2.0 * n_edges * d_h * cfg.n_layers          # gather+scatter adds
                   + n_nodes * cfg.n_layers * 2 * (d_feat * d_h + d_h * d_h))
    # message gather + scatter traffic (fwd+bwd), plus one feature read
    mbytes = 3.0 * cfg.n_layers * 2.0 * n_edges * d_h * 4 + n_nodes * d_feat * 4
    return CellPlan(arch, spec.name, spec.kind, step,
                    (model, opt_s, batch_s), (psh, osh, bsh),
                    (psh, osh, None), (0, 1), flops, mbytes)


# ---------------------------------------------------------------------------
# Co-occurrence cells (the paper's own workload)
# ---------------------------------------------------------------------------


#: the CSL corpus model of ``data/corpus.py::synthetic_csl`` (Poisson
#: document lengths of mean 12, Zipf(1.15) term ids over ranks + 2.7),
#: which a cell's postings, new documents and seeds are drawn from on a
#: device
CSL_MEAN_LEN, CSL_ZIPF_A, CSL_ZIPF_SHIFT = 12.0, 1.15, 2.7
#: the longest document drawn: a Poisson(12) length passes 64 with
#: probability below 1e-20, and the ingest cell's blocks are 64 wide
CSL_MAX_LEN = 64


def csl_term_cdf(vocab: int, device) -> torch.Tensor:
    """The cumulative Zipf distribution of ``synthetic_csl``'s term ids
    (id = rank), float64 on ``device``."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    p = (ranks + CSL_ZIPF_SHIFT) ** -CSL_ZIPF_A
    return torch.cumsum(p / p.sum(), 0)


def csl_draw_terms(shape, cdf: torch.Tensor, gen) -> torch.Tensor:
    """Term ids of ``shape`` drawn from ``cdf`` (:func:`csl_term_cdf`) by
    inversion, int64 on its device."""
    u = torch.rand(shape, generator=gen, dtype=torch.float64,
                   device=cdf.device)
    return torch.searchsorted(cdf, u).clamp_(max=cdf.numel() - 1)


def csl_docs(n_docs: int, vocab: int, mk: _Inputs) -> torch.Tensor:
    """``n_docs`` documents of the CSL corpus model drawn on the cell's
    device from its generator: lengths Poisson(12), at least 1 and at most
    :data:`CSL_MAX_LEN`, term ids Zipf(1.15) (repeats kept, as
    ``synthetic_csl`` keeps them); (n_docs, CSL_MAX_LEN) int32 padded with
    -1, the layout ``ingest`` takes."""
    dev, gen = mk.device, mk.gen
    lengths = torch.poisson(torch.full((n_docs,), CSL_MEAN_LEN, device=dev),
                            generator=gen).clamp_(1, CSL_MAX_LEN)
    terms = csl_draw_terms((n_docs, CSL_MAX_LEN), csl_term_cdf(vocab, dev),
                           gen)
    pad = torch.arange(CSL_MAX_LEN, device=dev) >= lengths[:, None]
    return terms.masked_fill_(pad, -1).to(torch.int32)


def _cooc_index_shapes(cfg: CoocConfig, mk: _Inputs,
                       n_live: Optional[int] = None) -> PackedIndex:
    """The index, ``cfg.n_words`` words deep: on a device, ``n_live``
    documents (all ``cfg.n_docs`` by default) of the CSL corpus model
    (:func:`csl_docs`) in its first slots, built by the port's ``ingest``;
    ``n_docs`` is their count, an int32 scalar."""
    w, v = cfg.n_words, cfg.vocab_size
    if mk.meta:
        return PackedIndex(packed=sds((w, v), torch.int32),
                           doc_freq=sds((v,), torch.int32),
                           n_docs=sds((), torch.int32))
    n_live = cfg.n_docs if n_live is None else n_live
    dev = mk.device
    empty = PackedIndex(torch.zeros((w, v), dtype=torch.int32, device=dev),
                        torch.zeros((v,), dtype=torch.int32, device=dev), 0)
    docs = csl_docs(n_live, v, mk)
    full = ingest(empty, docs, torch.ones(n_live, dtype=torch.bool,
                                          device=dev))
    del empty, docs
    return PackedIndex(packed=full.packed, doc_freq=full.doc_freq,
                       n_docs=torch.tensor(n_live, dtype=torch.int32,
                                           device=dev))


def _cooc_seeds(shape, vocab: int, mk: _Inputs) -> torch.Tensor:
    """Seed term ids: on a device, drawn as the corpus model draws its
    tokens (a frequent term is asked for more often)."""
    if mk.meta:
        return sds(shape, torch.int32)
    cdf = csl_term_cdf(vocab, mk.device)
    return csl_draw_terms(shape, cdf, mk.gen).to(torch.int32)


#: int64 arrays of a block's slots that bound ``ingest``'s temporaries
INGEST_TEMPS = 16


def _cooc_index_shardings(idx_s: PackedIndex) -> PackedIndex:
    return PackedIndex(
        packed=named_sharding(("docs", "terms"), idx_s.packed),
        doc_freq=named_sharding(("terms",), idx_s.doc_freq),
        n_docs=named_sharding((), idx_s.n_docs),
    )


def _int8_product(x: torch.Tensor) -> torch.Tensor:
    """C = Xᵀ X as int32, X (D, V) int8 0/1: ``torch._int_mm`` on a card
    (X is the ``.t()`` view of term-major storage, so Xᵀ is row-major and
    X column-major, as cuBLAS takes them) or placeholder, the plain
    integer product on the CPU."""
    if x.device.type == "cpu":
        xi = x.to(torch.int32)
        return xi.t() @ xi
    return torch._int_mm(x.t(), x)


def _cooc_cell(arch: str, cfg: CoocConfig, spec: ShapeSpec,
               mk: _Inputs) -> CellPlan:
    d = spec.dims
    # the ingest cell's index leaves its block's slots free to fill
    idx_s = _cooc_index_shapes(cfg, mk,
                               max(0, cfg.n_docs - d.get("new_docs", 0)))
    ish = _cooc_index_shardings(idx_s)
    w, v = cfg.n_words, cfg.vocab_size
    # the reference's knobs: the query method, the build's operand dtype
    method = os.environ.get("REPRO_COOC_METHOD", "gemm")
    build_dtype = os.environ.get("REPRO_BUILD_DTYPE", "int8")

    if spec.kind == "cooc_build":
        def build_step(index: PackedIndex):
            if build_dtype == "int8":
                # 0/1 int8 operands, int32 accumulation: exact for any D
                x = constrain(incidence_dense(index, torch.int8),
                              ("docs", "terms"))
                c = _int8_product(x)
            else:
                x = constrain(incidence_dense(index, torch.bfloat16),
                              ("docs", "terms"))
                c = traversal_construct_dense(x)
            return constrain(c, ("cooc_row", "terms"))

        xb = 1 if build_dtype == "int8" else 2
        flops = 2.0 * (w * 32) * float(v) * v
        mbytes = (w * 32.0) * v * xb + float(v) * v * 4  # X read + C write
        return CellPlan(arch, spec.name, spec.kind, build_step, (idx_s,),
                        (ish,), None, (), flops, mbytes,
                        note=f"traversal baseline as X^T X GEMM ({build_dtype})")

    if spec.kind == "cooc_query":
        nq = d.get("n_queries", 0)
        depth, beam, topk = d["depth"], d["beam"], d["topk"]
        if nq:
            fn = functools.partial(bfs_construct_batch, depth=depth, topk=topk,
                                   beam=beam, method=method)
            seeds_s = _cooc_seeds((nq, 4), v, mk)
            ssh = _logical_shardings((None, None), seeds_s)
            flops = 2.0 * nq * depth * beam * w * v / 4  # popcount words
        else:
            fn = functools.partial(bfs_construct, depth=depth, topk=topk,
                                   beam=beam, method=method)
            seeds_s = _cooc_seeds((4,), v, mk)
            ssh = _logical_shardings((None,), seeds_s)
            flops = 2.0 * depth * beam * w * v / 4
        # memory-bound: the mandatory work is one stream over the packed
        # index per BFS level (masks are shared across a level's frontier)
        mbytes = float(depth) * w * v * 4
        return CellPlan(arch, spec.name, spec.kind, fn, (idx_s, seeds_s),
                        (ish, ssh), None, (), flops, mbytes,
                        note="optimized algorithm (inverted-index BFS)")

    # cooc_ingest: append docs then answer one query (real-time scenario);
    # the query takes REPRO_COOC_METHOD too (the reference's stays "gemm")
    nd, ml = d["new_docs"], d["max_doc_len"]
    depth, beam, topk = d["depth"], d["beam"], d["topk"]

    def ingest_and_query(index: PackedIndex, new_terms, new_valid, seeds):
        idx2 = ingest(index, new_terms, new_valid)
        return bfs_construct(idx2, seeds, depth=depth, topk=topk, beam=beam,
                             method=method)

    def ingest_bound(index: PackedIndex, new_terms, new_valid, seeds):
        # ingest's output index and INGEST_TEMPS int64 arrays of the
        # block's slots (more than its (doc, term) keys and their sort
        # hold at once), all kept live through the query
        keys = index.packed.new_empty((INGEST_TEMPS, nd * ml),
                                      dtype=torch.int64)
        idx2 = PackedIndex(index.packed.clone(), index.doc_freq.clone(),
                           index.n_docs.clone())
        return keys, bfs_construct(idx2, seeds, depth=depth, topk=topk,
                                   beam=beam, method=method)

    # a block of the corpus model's documents, every one valid
    terms_s = mk((nd, ml), torch.int32) if mk.meta else \
        csl_docs(nd, v, mk)[:, :ml].contiguous()
    valid_s = mk((nd,), torch.bool) if mk.meta else \
        torch.ones(nd, dtype=torch.bool, device=mk.device)
    args = (idx_s, terms_s, valid_s, _cooc_seeds((4,), v, mk))
    insh = (ish, _logical_shardings((None, None), args[1]),
            _logical_shardings((None,), args[2]),
            _logical_shardings((None,), args[3]))
    flops = 2.0 * depth * beam * w * v / 4 + 2.0 * nd * ml
    mbytes = (2.0 + depth) * w * v * 4      # scatter read+write + BFS levels
    return CellPlan(arch, spec.name, spec.kind, ingest_and_query, args,
                    insh, None, (0,), flops, mbytes,
                    note="streaming ingest + query (real-time property)",
                    bound_fn=ingest_bound)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def plan_cell(arch: str, shape_name: str, *, device="meta",
              seed: int = 0) -> CellPlan:
    """Build the dry-run plan for one (arch x shape) cell.  Must be called
    inside ``sharding.axis_rules(mesh)``.  ``device="meta"`` gives
    stand-ins; a real device gives seeded inputs and a seeded model
    (``seed``) there."""
    cfg = get_config(arch)
    spec = cfg.shape(shape_name)
    mk = _Inputs(device, seed)
    if isinstance(cfg, LMConfig):
        if spec.kind == "train":
            return _lm_train_cell(arch, cfg, spec, mk)
        if spec.kind == "prefill":
            return _lm_prefill_cell(arch, cfg, spec, mk)
        if spec.kind == "decode":
            return _lm_decode_cell(arch, cfg, spec, mk)
        raise ValueError(spec.kind)
    if isinstance(cfg, GNNConfig):
        return _gnn_cell(arch, cfg, spec, mk)
    if isinstance(cfg, RecSysConfig):
        return _recsys_cell(arch, cfg, spec, mk)
    if isinstance(cfg, CoocConfig):
        return _cooc_cell(arch, cfg, spec, mk)
    raise TypeError(type(cfg))


def all_cells(include_cooc: bool = True):
    """Yield every (arch, shape_name) dry-run cell."""
    from repro_torch.configs import list_archs
    for arch in list_archs():
        cfg = get_config(arch)
        if isinstance(cfg, CoocConfig) and not include_cooc:
            continue
        for spec in cfg.shapes:
            yield arch, spec.name
