"""The configuration types the port's DLRM path needs: a copy of
``ShapeSpec``, ``RECSYS_SHAPES``, ``RecSysConfig`` and ``replace`` from
``repro.configs.base``.  The port has no mesh, optimizer or
rematerialisation of its own yet, so ``RecSysConfig`` keeps the reference's
distribution and optimizer knobs as plain data, unread."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    """One cell: which step to run and its input dimensions."""

    name: str
    kind: str  # train | serve | retrieval | decode | ...
    dims: Dict[str, int] = field(default_factory=dict)

    def __getitem__(self, k: str) -> int:
        return self.dims[k]


RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", dict(batch=65536)),
    ShapeSpec("serve_p99", "serve", dict(batch=512)),
    ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
    ShapeSpec("retrieval_cand", "retrieval",
              dict(batch=1, n_candidates=1000000)),
)


@dataclass(frozen=True)
class RecSysConfig:
    name: str = "base"
    family: str = "recsys"
    shapes: Tuple[ShapeSpec, ...] = RECSYS_SHAPES
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
    # the model
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

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name}: unknown shape {name!r}; have "
                       f"{[s.name for s in self.shapes]}")


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
