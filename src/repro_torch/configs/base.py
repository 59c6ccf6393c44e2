"""The port's configuration types: copies of ``ShapeSpec``, ``BaseConfig``,
``RECSYS_SHAPES``, ``RecSysConfig``, ``COOC_SHAPES``, ``CoocConfig`` and
``replace`` from ``repro.configs.base``.  Configs are pure data.  The port
has no mesh-sharded training, optimizer or rematerialisation of its own
yet, so ``BaseConfig``'s distribution and optimizer knobs are carried as
the reference's data, unread."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Tuple


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
