"""The port's configuration types: copies of ``ShapeSpec``, ``BaseConfig``,
``LM_SHAPES``, ``LMConfig``, ``GNN_SHAPES``, ``GNNConfig``,
``RECSYS_SHAPES``, ``RecSysConfig``, ``COOC_SHAPES``, ``CoocConfig`` and
``replace`` from ``repro.configs.base``.  Configs are pure data.  The port
has no mesh-sharded training, optimizer or rematerialisation of its own
yet, so ``BaseConfig``'s distribution and optimizer knobs are carried as
the reference's data, unread."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class ShapeSpec:
    """One cell: which step to run and its input dimensions."""

    name: str
    kind: str  # train | serve | retrieval | decode | cooc_build | ...
    dims: Dict[str, int] = field(default_factory=dict)

    def __getitem__(self, k: str) -> int:
        return self.dims[k]


@dataclass(frozen=True)
class BaseConfig:
    name: str = "base"
    family: str = "base"  # lm | gnn | recsys | cooccur
    shapes: Tuple[ShapeSpec, ...] = ()
    # distribution and optimizer knobs of the reference (unread here)
    fsdp: bool = False
    microbatches: int = 1
    remat: bool = True
    grad_compression: bool = False
    optimizer: str = "adamw"
    moment_dtype: str = "float32"
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name}: unknown shape {name!r}; have "
                       f"{[s.name for s in self.shapes]}")


# -- Language models --------------------------------------------------------

LM_SHAPES = (
    ShapeSpec("train_4k", "train", dict(seq_len=4096, global_batch=256)),
    ShapeSpec("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
    ShapeSpec("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
    ShapeSpec("long_500k", "decode", dict(seq_len=524288, global_batch=1)),
)


@dataclass(frozen=True)
class LMConfig(BaseConfig):
    family: str = "lm"
    n_layers: int = 4
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    d_ff: int = 2048
    vocab_size: int = 32000
    vocab_pad_multiple: int = 128   # physical vocab padded to a multiple
    rope_theta: float = 500000.0
    qkv_bias: bool = False          # Qwen1.5 style
    rmsnorm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_q_chunk: int = 1024        # query-chunked attention; 0 = full
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0     # leading dense FFN layers (DeepSeek/Kimi)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- MLA (DeepSeek) ---
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    shapes: Tuple[ShapeSpec, ...] = LM_SHAPES

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return int(np.ceil(self.vocab_size / m) * m)

    def _attn_params(self) -> int:
        d = self.d_model
        if self.mla:
            attn = d * (self.n_heads * (self.qk_nope_dim + self.qk_rope_dim))
            attn += d * (self.kv_lora_rank + self.qk_rope_dim)
            attn += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim
                                                        + self.v_head_dim)
            attn += self.n_heads * self.v_head_dim * d
            return attn
        return (d * self.n_heads * self.head_dim * 2
                + d * self.n_kv_heads * self.head_dim * 2)

    def n_params(self) -> int:
        """Approximate parameter count (for 6ND model-FLOPs)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        dense_ff = 3 * d * self.d_ff
        if self.moe:
            moe_ff = self.n_experts * 3 * d * self.d_ff_expert
            moe_ff += self.n_shared_experts * 3 * d * self.d_ff_expert
            moe_ff += d * self.n_experts  # router
            n_moe = L - self.first_dense_layers
            ff_total = self.first_dense_layers * dense_ff + n_moe * moe_ff
        else:
            ff_total = L * dense_ff
        return int(emb + L * self._attn_params() + ff_total + L * 2 * d + d)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if not self.moe:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        act_ff = (self.top_k + self.n_shared_experts) * 3 * d * self.d_ff_expert
        dense_ff = 3 * d * self.d_ff
        n_moe = L - self.first_dense_layers
        return int(emb + L * self._attn_params()
                   + self.first_dense_layers * dense_ff + n_moe * act_ff
                   + L * 2 * d + d)


# -- GNN --------------------------------------------------------------------

GNN_SHAPES = (
    ShapeSpec("full_graph_sm", "train",
              dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7)),
    ShapeSpec("minibatch_lg", "train",
              dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                   fanout0=15, fanout1=10, d_feat=602, n_classes=41)),
    ShapeSpec("ogb_products", "train",
              dict(n_nodes=2449029, n_edges=61859140, d_feat=100,
                   n_classes=47)),
    ShapeSpec("molecule", "train",
              dict(n_nodes=30, n_edges=64, batch=128, d_feat=16,
                   n_classes=2)),
)


@dataclass(frozen=True)
class GNNConfig(BaseConfig):
    family: str = "gnn"
    n_layers: int = 5
    d_hidden: int = 64
    aggregator: str = "sum"
    learnable_eps: bool = True
    shapes: Tuple[ShapeSpec, ...] = GNN_SHAPES


# -- RecSys -----------------------------------------------------------------

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", dict(batch=65536)),
    ShapeSpec("serve_p99", "serve", dict(batch=512)),
    ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
    ShapeSpec("retrieval_cand", "retrieval",
              dict(batch=1, n_candidates=1000000)),
)


@dataclass(frozen=True)
class RecSysConfig(BaseConfig):
    family: str = "recsys"
    interaction: str = "fm"   # fm | dot | self-attn-seq | bidir-seq
    n_dense: int = 0
    n_sparse: int = 39
    vocab_per_field: int = 1000000
    embed_dim: int = 10
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    mlp: Tuple[int, ...] = ()
    # sequential models
    n_items: int = 1000000
    seq_len: int = 0
    n_blocks: int = 0
    n_heads: int = 0
    multi_hot: int = 1        # ids per sparse field (bag size)
    shapes: Tuple[ShapeSpec, ...] = RECSYS_SHAPES


# -- The paper's own workload ------------------------------------------------

COOC_SHAPES = (
    # full traversal-style build (X^T X) over the whole CSL-scale corpus
    ShapeSpec("build_full", "cooc_build", dict(n_docs=396209, vocab=65536)),
    # one BFS query: seed -> depth-3 expansion, beam 32, top-k 16
    ShapeSpec("query_bfs_d3", "cooc_query",
              dict(n_docs=396209, vocab=65536, depth=3, beam=32, topk=16)),
    # batched concurrent queries (the paper's web-service scenario)
    ShapeSpec("query_batch", "cooc_query",
              dict(n_docs=396209, vocab=65536, depth=2, beam=16, topk=16,
                   n_queries=256)),
    # streaming ingest: append a block of new docs then answer a query
    ShapeSpec("stream_ingest", "cooc_ingest",
              dict(n_docs=396209, vocab=65536, new_docs=4096,
                   max_doc_len=64, depth=2, beam=32, topk=16)),
)


@dataclass(frozen=True)
class CoocConfig(BaseConfig):
    family: str = "cooccur"
    vocab_size: int = 65536
    n_docs: int = 396209
    default_depth: int = 3
    default_topk: int = 16
    default_beam: int = 32
    shapes: Tuple[ShapeSpec, ...] = COOC_SHAPES

    @property
    def n_words(self) -> int:
        """Packed 32-bit words along the doc axis."""
        return (self.n_docs + 31) // 32


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
