"""Shared layers of the port's models (copies of ``repro.models.layers``)."""
from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, device) -> torch.Tensor:
    """An (in_dim, out_dim) weight, N(0, 1) / sqrt(in_dim) drawn in fp32
    from ``generator`` (on ``device``'s type) and cast to ``dtype``.  The
    reference draws from a ``jax.random`` key, so the numbers differ; the
    distribution is the same."""
    w = torch.empty((in_dim, out_dim), dtype=torch.float32, device=device)
    w.normal_(generator=generator).mul_(1.0 / math.sqrt(in_dim))
    return w.to(dtype)
