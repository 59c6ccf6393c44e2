"""End-to-end trainer: a copy of ``repro.launch.train``.

Runs real steps on one device, the card unless the caller passes
``device="cpu"``, inside the logical-axis rules of the host mesh (as the
reference's does), with the reference's fault-tolerance stack:
checkpoint/restore with resume (the reference's on-disk format, so
either package resumes the other's run), the straggler watchdog and the
deterministic restartable data pipeline.

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm2 \\
        --full --batch 65536 --steps 20 --ckpt-dir /tmp/ckpt

Without ``--full`` the family's reduced config runs (the reference's
default, laptop scale).  Weights are drawn from a ``torch.Generator`` on
the device's type seeded with ``seed``: the reference draws from a
``jax.random`` key, so the numbers differ; to start both from the same
weights, save them as step 0 of a checkpoint and let ``train`` resume.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from repro_torch import pytree
from repro_torch.configs import get_config, list_archs, replace
from repro_torch.configs.base import CoocConfig, GNNConfig, LMConfig, RecSysConfig
from repro_torch.data import gnn_synthetic_graph, lm_batch, recsys_batch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import axis_rules
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.train import StragglerWatchdog, checkpoint, make_optimizer, make_train_step


def reduced_config(cfg):
    """Laptop-scale config of the same family (smoke-test contract)."""
    if isinstance(cfg, LMConfig):
        kw = dict(n_layers=2, d_model=128, n_heads=4, d_ff=256, vocab_size=512,
                  attn_q_chunk=0, microbatches=min(cfg.microbatches, 2),
                  fsdp=False, remat=False)
        if cfg.n_kv_heads < cfg.n_heads:
            kw["n_kv_heads"] = 2
        else:
            kw["n_kv_heads"] = 4
        kw["head_dim"] = 32
        if cfg.moe:
            kw.update(n_experts=4, top_k=2, d_ff_expert=64,
                      n_shared_experts=min(cfg.n_shared_experts, 1),
                      first_dense_layers=min(cfg.first_dense_layers, 1))
        if cfg.mla:
            kw.update(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                      v_head_dim=16)
        return replace(cfg, **kw)
    if isinstance(cfg, RecSysConfig):
        return replace(cfg, vocab_per_field=1000, n_items=1000,
                       seq_len=min(cfg.seq_len, 16) if cfg.seq_len else 0)
    if isinstance(cfg, GNNConfig):
        return cfg  # GIN is already tiny
    if isinstance(cfg, CoocConfig):
        return replace(cfg, vocab_size=512, n_docs=2000)
    raise TypeError(type(cfg))


def _tensors(batch, dev) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def make_batch_fn(cfg, batch: int, seq: int, device="cuda"):
    """step -> the step's batch as tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(cfg, LMConfig):
        return lambda step: _tensors(lm_batch(cfg, batch, seq, step), dev)
    if isinstance(cfg, RecSysConfig):
        return lambda step: _tensors(recsys_batch(cfg, batch, step), dev)
    if isinstance(cfg, GNNConfig):
        gb = _tensors(gnn_synthetic_graph(512, 2048, 32, 8, seed=0), dev)
        return lambda step: gb
    raise TypeError(type(cfg))


def make_loss(cfg):
    if isinstance(cfg, LMConfig):
        return lambda m, b: T.loss_fn(cfg, m, b)
    if isinstance(cfg, RecSysConfig):
        return lambda m, b: R.loss_fn(cfg, m, b)
    if isinstance(cfg, GNNConfig):
        return lambda m, b: G.node_loss(cfg, m, b)
    raise TypeError(type(cfg))


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """The model of ``cfg``, fp32, weights drawn from ``generator`` (on
    ``device``'s type)."""
    if isinstance(cfg, LMConfig):
        return T.init_params(cfg, generator, device=device,
                             dtype=torch.float32)
    if isinstance(cfg, RecSysConfig):
        return R.init_params(cfg, generator, device=device)
    if isinstance(cfg, GNNConfig):
        return G.init_gin(cfg, generator, 32, 8, device=device)
    raise TypeError(type(cfg))


def train(arch: str, *, steps: int = 20, batch: int = 8, seq: int = 64,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
          reduce: bool = True, resume: bool = True, async_ckpt: bool = True,
          seed: int = 0, log_every: int = 5, device="cuda") -> Dict:
    cfg = get_config(arch)
    if isinstance(cfg, CoocConfig):
        raise ValueError("cooccur-csl is a query workload; see examples/ and "
                         "repro_torch.serve.CoocEngine / CoocServer")
    if reduce:
        cfg = reduced_config(cfg)
    dev = resolve_device(device)

    mesh = make_host_mesh(dev)
    loss_fn = make_loss(cfg)
    opt = make_optimizer(cfg)
    step_fn = make_train_step(cfg, loss_fn, opt)
    batch_fn = make_batch_fn(cfg, batch, seq, dev)

    with axis_rules(mesh):
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = init_params(cfg, gen, device=dev)
        opt_state = opt.init(pytree.module_tree(model))
        start = 0
        if ckpt_dir and resume and \
                checkpoint.latest_step(ckpt_dir) is not None:
            (params, opt_state), start = checkpoint.restore(
                ckpt_dir, (pytree.module_tree(model), opt_state))
            pytree.load_module_tree(model, params)
            del params
            print(f"resumed from step {start}")

        dog = StragglerWatchdog()
        metrics = {}
        pending = None
        for s in range(start, steps):
            dog.start_step(s)
            b = batch_fn(s)
            model, opt_state, metrics = step_fn(model, opt_state, b)
            loss = float(metrics["loss"])          # waits for the step
            ev = dog.end_step()
            if ev is not None:
                print(f"  straggler @ step {ev.step}: {ev.step_time:.3f}s "
                      f"({ev.ratio:.1f}x median)")
            if s % log_every == 0 or s == steps - 1:
                print(f"step {s}: loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
            if ckpt_dir and (s + 1) % ckpt_every == 0:
                if pending is not None:
                    pending.join()
                pending = checkpoint.save(
                    ckpt_dir, s + 1, (pytree.module_tree(model), opt_state),
                    blocking=not async_ckpt)
        if pending is not None:
            pending.join()
        if ckpt_dir:
            checkpoint.save(ckpt_dir, steps, (pytree.module_tree(model),
                                              opt_state))
        return {"loss": float(metrics["loss"]), "steps": steps,
                "straggler_stats": dog.stats()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--full", action="store_true",
                    help="full (published-size) config")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    out = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                reduce=not args.full, resume=not args.no_resume,
                device=args.device)
    print("final:", out)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
