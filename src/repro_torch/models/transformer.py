"""Decoder-only LM: GQA or MLA attention, dense or MoE FFN.  A copy of
``repro.models.transformer``'s forward, training loss, prefill and
decode.

An :class:`LM` module holds what the reference's params pytree holds:
``embed`` (Vp, d), ``dense_layers`` and ``moe_layers`` (one
:class:`Block` a layer, where the reference stacks them on a leading
axis and scans), ``final_norm`` and, unless ``tie_embeddings``,
``lm_head`` (d, Vp).  Weights keep the reference's (in, out) layout.

Cache layout (the reference's): ``{"kv": (L, B, S, Hkv, cw), "length":
(B,) int32}``, the dense layers first, then the MoE layers.  GQA:
Hkv = n_kv_heads, cw = 2 * head_dim (k | v); MLA: Hkv = 1, cw = r + dr
(the compressed c_kv | the rope key).

:func:`decode_step` attends over the cache and the current token without
writing the cache first (``ops.decode_attn``, plain PyTorch, as the
reference's is plain XLA), then writes every layer's entry with one
scatter into the cache's ``kv`` tensor in place: the reference's serving
jit donates that buffer.  A write at a position >= S is dropped, as the
reference's out-of-range scatter drops it.  MoE layers route dropless at
inference (capacity E / top_k).

:func:`loss_fn` is the reference's chunked fp32 cross-entropy plus the
MoE router's aux loss, differentiable; with ``cfg.remat`` each block is
recomputed in the backward (``torch.utils.checkpoint``, where the
reference has ``jax.checkpoint``).  :func:`prefill` and
:func:`decode_step` serve, and build no graph.  :func:`param_specs` and
:func:`cache_specs` are the reference's logical-axis trees, in the
reference's layout (the stacked layers of :func:`params_to_reference`),
for :mod:`repro_torch.launch.sharding`.  Everything runs on ``cuda``
unless the caller passes ``device="cpu"`` (or ``"meta"``, to plan).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import pytree
from repro_torch.configs.base import LMConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    apply_rope,
    assign_from_reference,
    ParamMaker,
    attention,
    mm,
    reference_tensor,
    rmsnorm,
    swiglu,
)


# ---------------------------------------------------------------------------
# Modules and init
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """GQA: ``wq``, ``wk``, ``wv``, ``wo`` (and ``bq``, ``bk``, ``bv`` with
    ``qkv_bias``); MLA: ``wq``, ``wdkv``, ``wkr``, ``wuk``, ``wuv``,
    ``wo``."""

    def __init__(self, cfg: LMConfig, mk: ParamMaker):
        super().__init__()
        d = cfg.d_model
        if cfg.mla:
            dn, dr, dv, r, h = (cfg.qk_nope_dim, cfg.qk_rope_dim,
                                cfg.v_head_dim, cfg.kv_lora_rank, cfg.n_heads)
            self.wq = mk.dense(d, h * (dn + dr))
            self.wdkv = mk.dense(d, r)
            self.wkr = mk.dense(d, dr)
            self.wuk = mk.dense(r, h * dn)
            self.wuv = mk.dense(r, h * dv)
            self.wo = mk.dense(h * dv, d)
            return
        hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        self.wq = mk.dense(d, hq)
        self.wk = mk.dense(d, hkv)
        self.wv = mk.dense(d, hkv)
        self.wo = mk.dense(hq, d)
        if cfg.qkv_bias:
            self.bq = mk.const((hq,), 0.0)
            self.bk = mk.const((hkv,), 0.0)
            self.bv = mk.const((hkv,), 0.0)


class FFN(nn.Module):
    """The dense SwiGLU FFN: ``w1``, ``w3`` (d, ff) and ``w2`` (ff, d)."""

    def __init__(self, cfg: LMConfig, mk: ParamMaker):
        super().__init__()
        self.w1 = mk.dense(cfg.d_model, cfg.d_ff)
        self.w3 = mk.dense(cfg.d_model, cfg.d_ff)
        self.w2 = mk.dense(cfg.d_ff, cfg.d_model)


class Block(nn.Module):
    """One layer: ``ln1``, ``attn``, ``ln2``, then ``ffn`` or ``moe``."""

    def __init__(self, cfg: LMConfig, is_moe: bool, mk: ParamMaker):
        super().__init__()
        self.is_moe = is_moe
        self.ln1 = mk.const((cfg.d_model,), 1.0)
        self.ln2 = mk.const((cfg.d_model,), 1.0)
        self.attn = Attention(cfg, mk)
        if is_moe:
            self.moe = moe_lib.MoE(cfg.d_model, cfg.d_ff_expert,
                                   cfg.n_experts, cfg.n_shared_experts,
                                   dtype=mk.dtype, device=mk.device,
                                   generator=mk.gen)
        else:
            self.ffn = FFN(cfg, mk)


def _layer_counts(cfg: LMConfig) -> Tuple[int, int]:
    n_dense = cfg.first_dense_layers if cfg.moe else cfg.n_layers
    n_moe = (cfg.n_layers - cfg.first_dense_layers) if cfg.moe else 0
    return n_dense, n_moe


class LM(nn.Module):
    """The reference's LM params as a module (see the module docstring).
    With a ``generator`` the weights are drawn as the reference's
    ``init_params`` draws them; without one they are left empty, to be
    filled by :func:`params_from_reference`."""

    def __init__(self, cfg: LMConfig, *, device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mk = ParamMaker(dtype, resolve_device(device), generator)
        self.cfg = cfg
        n_dense, n_moe = _layer_counts(cfg)
        vp = cfg.padded_vocab
        self.embed = mk.dense(vp, cfg.d_model)
        self.final_norm = mk.const((cfg.d_model,), 1.0)
        self.dense_layers = nn.ModuleList(
            Block(cfg, False, mk) for _ in range(n_dense))
        self.moe_layers = nn.ModuleList(
            Block(cfg, True, mk) for _ in range(n_moe))
        if not cfg.tie_embeddings:
            self.lm_head = mk.dense(cfg.d_model, vp)

    def blocks(self) -> List[Block]:
        """Every layer in cache order: the dense layers, then the MoE."""
        return list(self.dense_layers) + list(self.moe_layers)

    def reference_layout(self) -> List[pytree.Leaf]:
        """The reference's pytree: ``embed``, ``final_norm`` and
        ``lm_head`` as they are, each stack's layers on a leading axis."""
        own = [pytree.Leaf((n,), (n,))
               for n, _ in self.named_parameters(recurse=False)]
        return (own + pytree.stacked_layout("dense_layers", self.dense_layers)
                + pytree.stacked_layout("moe_layers", self.moe_layers))


def init_params(cfg: LMConfig, generator: torch.Generator, *, device="cuda",
                dtype: torch.dtype = torch.bfloat16) -> LM:
    """An :class:`LM` of ``cfg`` with weights drawn from ``generator`` (on
    ``device``'s type): N(0, 1) / sqrt(in) in fp32, cast to ``dtype``;
    zero biases, unit norms, an fp32 router.  The reference draws from a
    ``jax.random`` key, so the numbers differ; the distribution is the
    same."""
    return LM(cfg, device=device, dtype=dtype, generator=generator)


def params_from_reference(cfg: LMConfig, params: Mapping,
                          device="cuda") -> LM:
    """The reference's ``init_params`` pytree (numpy leaves, layers stacked
    on a leading axis) as an :class:`LM` on ``device``, each weight in its
    own dtype (the embedding's for the module, fp32 for the router)."""
    model = LM(cfg, device=device,
               dtype=reference_tensor(params["embed"]).dtype)
    stacks = {"dense_layers": model.dense_layers,
              "moe_layers": model.moe_layers}
    assign_from_reference(model, {k: v for k, v in params.items()
                                  if k not in stacks}, recurse=False)
    for key, blocks in stacks.items():
        stack = params.get(key)
        if (stack is None) != (len(blocks) == 0):
            raise ValueError(f"{key}: the reference's and {cfg.name}'s "
                             "layers differ")
        for i, block in enumerate(blocks):
            assign_from_reference(block, _index_tree(stack, i))
    return model


def params_to_reference(cfg: LMConfig, model: LM):
    """The inverse of :func:`params_from_reference`: the reference's
    ``init_params`` pytree of the module's weights as detached tensors,
    each stack's layers on a leading axis (new tensors; the other leaves
    share the parameters' storage)."""
    return pytree.module_tree(model)


def param_specs(cfg: LMConfig) -> Dict:
    """Tree of logical-axis tuples in :func:`params_to_reference`'s layout
    (each stack's layers on a leading axis): the reference's.

    "fsdp" resolves to the data axis only when cfg.fsdp (else it is
    dropped); indivisible dims degrade to replication.
    """
    f = "fsdp" if cfg.fsdp else None

    def attn_specs() -> Dict:
        if cfg.mla:
            return {
                "wq": (f, "heads"), "wdkv": (f, None), "wkr": (f, None),
                "wuk": (None, "heads"), "wuv": (None, "heads"),
                "wo": ("heads", f),
            }
        s = {"wq": (f, "heads"), "wk": (f, "kv_heads"), "wv": (f, "kv_heads"),
             "wo": ("heads", f)}
        if cfg.qkv_bias:
            s.update({"bq": ("heads",), "bk": ("kv_heads",),
                      "bv": ("kv_heads",)})
        return s

    def block_specs(is_moe: bool) -> Dict:
        p = {"ln1": (None,), "ln2": (None,), "attn": attn_specs()}
        if is_moe:
            p["moe"] = {
                "router": (None, None),
                "w1": ("experts", f, None), "w3": ("experts", f, None),
                "w2": ("experts", None, f),
            }
            if cfg.n_shared_experts:
                p["moe"].update({"shared_w1": (f, "ff"),
                                 "shared_w3": (f, "ff"),
                                 "shared_w2": ("ff", f)})
        else:
            p["ffn"] = {"w1": (f, "ff"), "w3": (f, "ff"), "w2": ("ff", f)}
        return p

    def stacked(d: Dict) -> Dict:
        return {k: stacked(v) if isinstance(v, dict) else (None,) + v
                for k, v in d.items()}

    n_dense, n_moe = _layer_counts(cfg)
    specs = {"embed": ("vocab", f), "final_norm": (None,)}
    if n_dense:
        specs["dense_layers"] = stacked(block_specs(False))
    if n_moe:
        specs["moe_layers"] = stacked(block_specs(True))
    if not cfg.tie_embeddings:
        specs["lm_head"] = (f, "vocab")
    return specs


def _index_tree(tree, i):
    if isinstance(tree, Mapping):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Attention paths
# ---------------------------------------------------------------------------


def _gqa_qkv(cfg: LMConfig, p: Attention, x: torch.Tensor,
             positions: torch.Tensor):
    b, s, _ = x.shape
    q, k, v = mm(x, p.wq), mm(x, p.wk), mm(x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mla_qkv(cfg: LMConfig, p: Attention, x: torch.Tensor,
             positions: torch.Tensor):
    """Returns (q_cat, k_cat, v, compressed cache entry (B, S, 1, r+dr))."""
    b, s, _ = x.shape
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    q = mm(x, p.wq).reshape(b, s, h, dn + dr)
    qn, qr = q[..., :dn], q[..., dn:]
    qr = apply_rope(qr, positions, cfg.rope_theta)
    ckv = mm(x, p.wdkv)                                      # (B, S, r)
    kr = apply_rope(mm(x, p.wkr), positions, cfg.rope_theta)  # (B, S, dr)
    kn = mm(ckv, p.wuk).reshape(b, s, h, dn)
    v = mm(ckv, p.wuv).reshape(b, s, h, dv)
    q_cat = torch.cat([qn, qr], dim=-1)
    k_cat = torch.cat([kn, kr[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    cache_entry = torch.cat([ckv, kr], dim=-1)[:, :, None, :]
    return q_cat, k_cat, v, cache_entry


def _self_attention(cfg: LMConfig, p: Attention, x: torch.Tensor,
                    positions: torch.Tensor):
    """Returns (attn_out (B, S, d), cache entry (B, S, Hkv, cw))."""
    b, s, _ = x.shape
    if cfg.mla:
        q, k, v, cache_entry = _mla_qkv(cfg, p, x, positions)
        scale = 1.0 / float(cfg.qk_nope_dim + cfg.qk_rope_dim) ** 0.5
        out = attention(q, k, v, causal=True, q_chunk=cfg.attn_q_chunk,
                        scale=scale)
        out = out.reshape(b, s, cfg.n_heads * cfg.v_head_dim)
    else:
        q, k, v = _gqa_qkv(cfg, p, x, positions)
        cache_entry = torch.cat([k, v], dim=-1)              # (B,S,Hkv,2dh)
        out = attention(q, k, v, causal=True, q_chunk=cfg.attn_q_chunk)
        out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return mm(out, p.wo), cache_entry


# ---------------------------------------------------------------------------
# Blocks and forward
# ---------------------------------------------------------------------------


def _infer_capacity(cfg: LMConfig) -> float:
    """Dropless capacity for inference: every token is kept."""
    return float(cfg.n_experts) / max(cfg.top_k, 1)


def _ffn(cfg: LMConfig, p: Block, hn: torch.Tensor, capacity_factor: float):
    """The block's FFN on hn (..., d) -> (out (..., d), aux loss)."""
    if p.is_moe:
        shape = hn.shape
        y, aux = moe_lib.moe_ffn(p.moe, hn.reshape(-1, shape[-1]),
                                 top_k=cfg.top_k,
                                 capacity_factor=capacity_factor,
                                 router_aux_weight=cfg.router_aux_weight)
        return y.reshape(shape), aux
    return (swiglu(hn, p.ffn.w1, p.ffn.w3, p.ffn.w2),
            torch.zeros((), dtype=torch.float32, device=hn.device))


def _block(cfg: LMConfig, p: Block, h: torch.Tensor, positions: torch.Tensor,
           inference: bool = False):
    attn_out, cache_entry = _self_attention(
        cfg, p.attn, rmsnorm(h, p.ln1, cfg.rmsnorm_eps), positions)
    h = h + attn_out
    hn = rmsnorm(h, p.ln2, cfg.rmsnorm_eps)
    cf = _infer_capacity(cfg) if inference else cfg.capacity_factor
    y, aux = _ffn(cfg, p, hn, cf)
    return h + y, aux, cache_entry


def forward(cfg: LMConfig, model: LM, tokens: torch.Tensor,
            emit_cache: bool = False, inference: Optional[bool] = None):
    """tokens (B, S) -> (hidden (B, S, d), aux loss, (dense caches, MoE
    caches)), each cache (n, B, S, Hkv, cw) or None.

    inference=True routes the MoE layers dropless (it defaults to
    emit_cache: prefill is inference)."""
    if inference is None:
        inference = emit_cache
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :]
    h = model.embed[tokens.to(torch.int64)]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = cfg.remat and torch.is_grad_enabled()
    caches = []
    for blocks in (model.dense_layers, model.moe_layers):
        entries = []
        for p in blocks:
            if remat:
                h, a, entry = torch.utils.checkpoint.checkpoint(
                    _block, cfg, p, h, positions, inference,
                    use_reentrant=False)
            else:
                h, a, entry = _block(cfg, p, h, positions, inference)
            aux = aux + a
            if emit_cache:
                entries.append(entry)
        caches.append(torch.stack(entries) if entries else None)
    h = rmsnorm(h, model.final_norm, cfg.rmsnorm_eps)
    return h, aux, tuple(caches)


def _lm_head(cfg: LMConfig, model: LM) -> torch.Tensor:
    return model.embed.t() if cfg.tie_embeddings else model.lm_head


def logits_for(cfg: LMConfig, model: LM, h: torch.Tensor) -> torch.Tensor:
    """h (..., d) -> fp32 logits (..., Vp), the padded vocab at -1e30.  The
    head is cast to fp32 on every call, as the reference casts it."""
    w = _lm_head(cfg, model)
    logits = torch.matmul(h.to(torch.float32), w.to(torch.float32))
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def loss_fn(cfg: LMConfig, model: LM, batch: Dict[str, torch.Tensor], *,
            ce_chunk: int = 512):
    """batch: tokens (B, S), labels (B, S), mask (B, S) -> (loss, metrics).

    The cross-entropy runs over sequence chunks of ``ce_chunk`` (one chunk
    when S is not a multiple), each through fp32 logits; the loss is the
    masked mean plus the MoE router's aux loss."""
    h, aux, _ = forward(cfg, model, batch["tokens"])
    s = h.shape[1]
    labels = batch["labels"].to(torch.int64)
    mask = batch["mask"].to(torch.float32)
    chunk = min(ce_chunk, s)
    n = s // chunk if s % chunk == 0 else 1
    chunk = s // n
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        logits = logits_for(cfg, model, h[:, sl])        # (B, chunk, Vp)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, sl, None])[..., 0]
        tot = tot + torch.sum((lse - gold) * mask[:, sl])
        cnt = cnt + torch.sum(mask[:, sl])
    ce = tot / torch.clamp(cnt, min=1.0)
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux, "tokens": cnt}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def kv_cache_dims(cfg: LMConfig) -> Tuple[int, int]:
    """(n_kv_heads, per-head cache width) of the cache layout."""
    if cfg.mla:
        return 1, cfg.kv_lora_rank + cfg.qk_rope_dim
    return cfg.n_kv_heads, 2 * cfg.head_dim


def cache_specs(cfg: LMConfig, long_context: bool) -> Dict:
    """Logical axes for the cache tree: the reference's.

    Sequence dim shards over "model" ("kv_seq" adds "data" for the
    batch=1 long-context cell); kv_heads picks up whatever remains (it
    degrades to replication when the model axis is already consumed or
    indivisible — e.g. 8 GQA heads on a 16-way axis)."""
    seq_ax = "kv_seq" if long_context else "seq"
    return {"kv": (None, "batch", seq_ax, "kv_heads", None),
            "length": ("batch",)}


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, *,
               device="cuda") -> Dict[str, torch.Tensor]:
    hkv, cw = kv_cache_dims(cfg)
    dev = resolve_device(device)
    return {
        "kv": torch.zeros((cfg.n_layers, batch, max_len, hkv, cw),
                          dtype=dtype, device=dev),
        "length": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def prefill(cfg: LMConfig, model: LM, tokens: torch.Tensor,
            max_len: Optional[int] = None):
    """tokens (B, S) -> (last-token fp32 logits (B, Vp), cache).

    max_len pads the cache's sequence axis so later :func:`decode_step`
    calls have room to write (a write at pos >= capacity is dropped)."""
    h, _, (c1, c2) = forward(cfg, model, tokens, emit_cache=True)
    parts = [c for c in (c1, c2) if c is not None]
    kv = torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]
    if max_len is not None and max_len > tokens.shape[1]:
        pad = max_len - tokens.shape[1]
        kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, pad))
    b, s = tokens.shape
    cache = {"kv": kv,
             "length": torch.full((b,), s, dtype=torch.int32,
                                  device=tokens.device)}
    return logits_for(cfg, model, h[:, -1]), cache


def _decode_attn(cfg: LMConfig, p: Attention, x: torch.Tensor,
                 kv: torch.Tensor, pos: torch.Tensor):
    """x (B, d); kv (B, S, Hkv, cw) the layer's cache, read only; pos (B,)
    each sequence's position.  Returns (out (B, d), entry (B, Hkv, cw))."""
    b, d = x.shape
    f32 = torch.float32
    bpos = pos[:, None]                                      # (B, 1)
    if cfg.mla:
        h, dn, dr, dv, r = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                            cfg.v_head_dim, cfg.kv_lora_rank)
        q = mm(x, p.wq).reshape(b, h, dn + dr)
        qn, qr = q[..., :dn], q[..., dn:]
        qr = apply_rope(qr[:, None], bpos, cfg.rope_theta)[:, 0]
        # weight absorption: the query into the compressed space, in fp32
        wuk = p.wuk.reshape(r, h, dn)
        qc = torch.einsum("bhn,rhn->bhr", qn.to(f32),
                          wuk.to(f32)).to(x.dtype)
        q_eff = torch.cat([qc, qr], dim=-1)                  # (B, H, r+dr)
        # decode_attn divides by sqrt(r + dr); the softmax wants
        # sqrt(dn + dr).  The reference's Python scalar takes the array's
        # dtype before the product, so it is rounded to it here too (on
        # the host: a scalar sent to the card would stall its queue).
        ratio = float(r + dr) ** 0.5 / float(dn + dr) ** 0.5
        q_eff = q_eff * torch.tensor(ratio, dtype=q_eff.dtype).item()
        ckv = mm(x, p.wdkv)
        kr = apply_rope(mm(x, p.wkr)[:, None], bpos, cfg.rope_theta)[:, 0]
        entry = torch.cat([ckv, kr], dim=-1)[:, None, :].to(kv.dtype)
        # the cache serves as keys and values; only ctx[..., :r] is used
        ctx = ops.decode_attn(q_eff, kv, kv, pos, entry, entry)
        wuv = p.wuv.reshape(r, h, dv)
        out = torch.einsum("bhr,rhv->bhv", ctx[..., :r].to(f32),
                           wuv.to(f32)).to(x.dtype)
        return mm(out.reshape(b, h * dv), p.wo), entry
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = mm(x, p.wq), mm(x, p.wk), mm(x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = apply_rope(q.reshape(b, hq, dh)[:, None], bpos, cfg.rope_theta)[:, 0]
    k = apply_rope(k.reshape(b, hkv, dh)[:, None], bpos,
                   cfg.rope_theta)[:, 0]
    v = v.reshape(b, hkv, dh)
    entry = torch.cat([k, v], dim=-1).to(kv.dtype)
    ctx = ops.decode_attn(q, kv[..., :dh], kv[..., dh:], pos,
                          k.to(kv.dtype), v.to(kv.dtype))
    return mm(ctx.reshape(b, hq * dh), p.wo), entry


def _decode_block(cfg: LMConfig, p: Block, h: torch.Tensor, kv: torch.Tensor,
                  pos: torch.Tensor):
    attn_out, entry = _decode_attn(cfg, p.attn,
                                   rmsnorm(h, p.ln1, cfg.rmsnorm_eps), kv, pos)
    h = h + attn_out
    y, _ = _ffn(cfg, p, rmsnorm(h, p.ln2, cfg.rmsnorm_eps),
                _infer_capacity(cfg))
    return h + y, entry


@torch.no_grad()
def decode_step(cfg: LMConfig, model: LM, cache: Dict[str, torch.Tensor],
                token: torch.Tensor):
    """token (B,) -> (fp32 logits (B, Vp), updated cache).

    The blocks only read the cache; every layer's new entry is written
    afterwards with one scatter into ``cache["kv"]``, in place (the
    reference's serving jit donates that buffer), at each row's position.
    A row whose position is >= S writes nothing.  The returned cache holds
    the same ``kv`` tensor and the lengths plus one."""
    pos = cache["length"]
    kv = cache["kv"]
    h = model.embed[token.to(torch.int64)]                   # (B, d)
    entries = []
    for layer, p in enumerate(model.blocks()):
        h, entry = _decode_block(cfg, p, h, kv[layer], pos)
        entries.append(entry)
    all_entries = torch.stack(entries).to(kv.dtype)          # (L,B,Hkv,cw)

    # one scatter; an out-of-range row rewrites its last slot unchanged
    s = kv.shape[2]
    bidx = torch.arange(kv.shape[1], device=kv.device)
    ok = (pos >= 0) & (pos < s)
    at = pos.clamp(0, s - 1).to(torch.int64)
    kv[:, bidx, at] = torch.where(ok[None, :, None, None], all_entries,
                                  kv[:, bidx, at])

    h = rmsnorm(h, model.final_norm, cfg.rmsnorm_eps)
    return logits_for(cfg, model, h), {"kv": kv, "length": pos + 1}
