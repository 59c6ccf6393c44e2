"""Shared layers of the port's models: copies of ``repro.models.layers``
(``dense_init``, RMSNorm, RoPE, chunked attention, SwiGLU), as functions
over tensors.

The reference's einsums promote mixed dtypes (bf16 with fp32 gives fp32)
and accumulate its attention products in fp32 whatever the storage dtype
(``preferred_element_type``).  ``torch.matmul`` refuses mixed dtypes and
rounds its output to the inputs' dtype, so :func:`mm` promotes as JAX
does, and the attention products run on fp32 copies of their operands: a
product of two bf16 values is exact in fp32, so this is the reference's
arithmetic.  On a card the fp32 products must not run in TF32 for that to
hold (``torch.backends.cuda.matmul.allow_tf32``, off by default).
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, device) -> torch.Tensor:
    """An (in_dim, out_dim) weight, N(0, 1) / sqrt(in_dim) drawn in fp32
    from ``generator`` (on ``device``'s type) and cast to ``dtype``.  The
    reference draws from a ``jax.random`` key, so the numbers differ; the
    distribution is the same."""
    return draw_dense(generator, (in_dim, out_dim), dtype, device)


def draw_dense(generator: torch.Generator, shape, dtype: torch.dtype,
               device) -> torch.Tensor:
    """:func:`dense_init`'s draw for a weight of any ``shape`` whose last
    two axes are (in, out), such as stacked (E, in, out) experts."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(generator=generator).mul_(1.0 / math.sqrt(shape[-2]))
    return w.to(dtype)


class ParamMaker:
    """Trainable weights on one device in one dtype, drawn from ``generator``
    as the reference's initialisers draw theirs, or left empty without one
    (to be filled from the reference's pytree): ``dense(in, out)`` as
    :func:`dense_init`, ``normal(shape, std)`` N(0, 1) x ``std`` drawn in
    fp32; ``const(shape, value)`` is filled (norms with 1, biases with 0),
    in ``dtype`` if given."""

    def __init__(self, dtype, device, generator):
        self.dtype, self.device, self.gen = dtype, device, generator

    def dense(self, in_dim, out_dim):
        if self.gen is None:
            w = torch.empty((in_dim, out_dim), dtype=self.dtype,
                            device=self.device)
        else:
            w = dense_init(self.gen, in_dim, out_dim, self.dtype, self.device)
        return nn.Parameter(w)

    def normal(self, shape, std: float):
        w = torch.empty(shape, dtype=torch.float32, device=self.device)
        if self.gen is not None:
            w.normal_(generator=self.gen).mul_(std)
        return nn.Parameter(w.to(self.dtype))

    def const(self, shape, value, dtype=None):
        return nn.Parameter(torch.full(shape, value, dtype=dtype or self.dtype,
                                       device=self.device))


def require_full_fp32(x: torch.Tensor, what: str) -> None:
    """Refuse to run ``what``'s fp32 products on a card while TF32 is
    allowed for them: the reference computes them in full fp32."""
    if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32 or
                      torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            f"{what} run in full fp32, as the reference does: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as a JAX einsum gives."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.to(torch.float32)).to(x.dtype)


# -- rotary ------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device="cuda") -> torch.Tensor:
    """The (dim / 2,) fp32 rotary frequencies, on ``device`` (the card
    unless the caller asks for the CPU)."""
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=resolve_device(device))
                            / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, dh) or (..., S, dh); positions broadcastable to
    (..., S).  The last axis splits into halves, not interleaved pairs."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # (dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, dh/2)
    if x.dim() == angles.dim() + 1:                          # head axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- attention ---------------------------------------------------------------


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
            scale: float) -> torch.Tensor:
    """q (B, Sq, Hkv, G, dh); k, v (B, Skv, Hkv, dh) -> (B, Sq, Hkv, G, dv).

    Products accumulate in fp32; the softmax is fp32 and its probabilities
    are cast once to v's dtype, as the reference's."""
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]              # (Sq, Skv)
        scores = torch.where(mask[None, None, None], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd",
                       p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_chunk: int = 0, q_offset: int = 0,
              scale: Optional[float] = None) -> torch.Tensor:
    """Chunked multi-head attention.

    q (B, Sq, Hq, dh); k (B, Skv, Hkv, dh), v (B, Skv, Hkv, dv), Hq % Hkv
    == 0.  q_chunk > 0 and Sq % q_chunk == 0 -> one query chunk at a time
    (the reference's ``lax.scan``), so the (Sq, Skv) score tensor never
    materialises.  Returns (B, Sq, Hq, dv) in q.dtype.
    """
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]                                    # may differ (MLA)
    g = hq // hkv
    sc = scale if scale is not None else 1.0 / float(dh) ** 0.5
    qg = q.reshape(b, sq, hkv, g, dh)
    k_pos = torch.arange(skv, device=q.device)
    if q_chunk <= 0 or sq <= q_chunk or sq % q_chunk != 0:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        out = _attend(qg, k, v, q_pos, k_pos, causal, sc)
        return out.reshape(b, sq, hq, dv)
    outs = []
    for c0 in range(0, sq, q_chunk):
        q_pos = q_offset + c0 + torch.arange(q_chunk, device=q.device)
        outs.append(_attend(qg[:, c0:c0 + q_chunk], k, v, q_pos, k_pos,
                            causal, sc))
    return torch.cat(outs, dim=1).reshape(b, sq, hq, dv)


# -- FFN ---------------------------------------------------------------------


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: (x@w1 * silu(x@w3)) @ w2, the gate's silu in fp32."""
    h = mm(x, w1)
    g = mm(x, w3)
    h = h * torch.nn.functional.silu(g.to(torch.float32)).to(h.dtype)
    return mm(h, w2)


# -- the reference's parameters ------------------------------------------------


def reference_tensor(a) -> torch.Tensor:
    """A writable host tensor of a reference leaf (numpy, or a JAX array
    converted with ``np.asarray``), bf16 included: numpy has no bf16 of its
    own, so those leaves arrive as ``ml_dtypes.bfloat16`` and are carried
    across bit for bit.  A tensor is taken as it is (detached)."""
    if isinstance(a, torch.Tensor):
        return a.detach()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.int16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaf_paths(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1]


def assign_from_reference(module: nn.Module, tree: Mapping, *,
                          recurse: bool = True) -> None:
    """Copy a reference parameter pytree into ``module``: each parameter's
    dotted name is its path in ``tree`` (``attn.wq`` is
    ``tree["attn"]["wq"]``).  The tree's leaves and the parameters must
    name the same weights, of the same shapes; each parameter keeps its
    own dtype.  ``recurse=False`` fills only the module's own
    parameters."""
    params = dict(module.named_parameters(recurse=recurse))
    leaves = set(_leaf_paths(tree))
    if leaves != set(params):
        raise ValueError(f"reference weights {sorted(leaves - set(params))} "
                         f"have no parameter; parameters "
                         f"{sorted(set(params) - leaves)} no weight")
    with torch.no_grad():
        for name, param in params.items():
            leaf = tree
            for part in name.split("."):
                leaf = leaf[part]
            src = reference_tensor(leaf)
            if tuple(src.shape) != tuple(param.shape):
                raise ValueError(f"{name}: reference shape {tuple(src.shape)}"
                                 f" != {tuple(param.shape)}")
            param.copy_(src)
