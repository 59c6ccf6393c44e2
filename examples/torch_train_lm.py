"""End-to-end LM training on the PyTorch port.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--device cpu]

The port of ``examples/train_lm.py``, through ``repro_torch`` alone; it
runs on the GPU unless ``--device cpu`` is given, and takes the
reference's arguments.  Trains a ~100M-param dense transformer (a
llama3-family reduction with real depth and width) for a few hundred
steps on a Zipf synthetic stream, with the full production stack:
atomic checkpointing every 50 steps in the reference's on-disk format,
crash-resume, straggler watchdog, cosine LR schedule.  Re-running the
script resumes from the latest checkpoint in ``--ckpt-dir`` (by default
``repro_torch_lm_ckpt`` in the temporary directory).
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.configs import get_config, replace
from repro_torch.data import lm_batch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import axis_rules
from repro_torch.models import transformer as T
from repro_torch.train import StragglerWatchdog, checkpoint, make_optimizer, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ~100M params: 12L x 768, GQA 12/4 heads, vocab 32k
    cfg = replace(
        get_config("llama3-8b"), n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
        attn_q_chunk=0, fsdp=False, remat=True, microbatches=2,
        learning_rate=3e-4, warmup_steps=20)
    n_params = cfg.n_params()
    print(f"model: {n_params/1e6:.0f}M params, {cfg.n_layers}L x {cfg.d_model}")

    mesh = make_host_mesh(dev)
    opt = make_optimizer(cfg)
    step_fn = make_train_step(cfg, lambda m, b: T.loss_fn(cfg, m, b), opt)

    with axis_rules(mesh):
        model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev, dtype=torch.float32)
        opt_state = opt.init(pytree.module_tree(model))
        start = 0
        if checkpoint.latest_step(args.ckpt_dir) is not None:
            (params, opt_state), start = checkpoint.restore(
                args.ckpt_dir, (pytree.module_tree(model), opt_state))
            pytree.load_module_tree(model, params)
            del params
            print(f"resumed from checkpoint at step {start}")

        dog = StragglerWatchdog()
        losses = []
        pending = None
        for s in range(start, args.steps):
            dog.start_step(s)
            b = {k: torch.from_numpy(v).to(dev) for k, v in
                 lm_batch(cfg, args.batch, args.seq, s).items()}
            model, opt_state, m = step_fn(model, opt_state, b)
            losses.append(float(m["loss"]))          # waits for the step
            dog.end_step()
            if s % 10 == 0 or s == args.steps - 1:
                print(f"step {s:4d}  loss {losses[-1]:.4f}  "
                      f"lr {float(m['lr']):.2e}")
            if (s + 1) % 50 == 0:
                if pending is not None:
                    pending.join()
                pending = checkpoint.save(
                    args.ckpt_dir, s + 1,
                    (pytree.module_tree(model), opt_state), blocking=False)
        if pending is not None:
            pending.join()
        checkpoint.save(args.ckpt_dir, args.steps,
                        (pytree.module_tree(model), opt_state))

    if not losses:
        print(f"nothing to train: the checkpoint is at step {start}")
        return
    first = np.mean(losses[:10]) if len(losses) >= 10 else losses[0]
    last = np.mean(losses[-10:])
    print(f"\nloss: {first:.3f} -> {last:.3f}  "
          f"({'LEARNING' if last < first else 'no improvement?'})")
    print(f"straggler stats: {dog.stats()}")


if __name__ == "__main__":
    main()
