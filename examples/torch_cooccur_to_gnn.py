"""Co-occurrence network -> GIN on the PyTorch port: the paper's output as
a first-class graph.

    PYTHONPATH=src python examples/torch_cooccur_to_gnn.py [--device cpu]

The port of ``examples/cooccur_to_gnn.py``, through ``repro_torch``
alone; it runs on the GPU unless ``--device cpu`` is given.  Builds a
keyword co-occurrence network over a synthetic CSL-like corpus with the
optimized algorithm (Algorithm 3), converts it to an edge index, and
trains the ``gin-tu`` architecture on it to classify terms into frequency
bands (a stand-in for topic labels).  The GIN weights are drawn from a
seeded ``torch.Generator``, so the losses differ from the reference's
(which draws from a ``jax.random`` key); the network is the same.
"""
import argparse

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.core import bfs_construct, pack_docs, to_edge_index
from repro_torch.data import synthetic_csl
from repro_torch.device import resolve_device
from repro_torch.models import gnn as G
from repro_torch.train import make_optimizer, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    vocab, n_docs = 512, 4000
    docs = synthetic_csl(n_docs, vocab, seed=0)
    index = pack_docs(docs, vocab, device=dev)
    df = index.doc_freq.cpu().numpy()

    # build the network from the top high-frequency seeds (paper §4)
    seeds = np.argsort(-df)[:8].astype(np.int32)
    pad = np.full((16,), -1, np.int32)
    pad[:8] = seeds
    net = bfs_construct(index, torch.from_numpy(pad), depth=3, topk=12,
                        beam=16)
    ei, ew = to_edge_index(net)
    print(f"co-occurrence network: {ei.shape[1] // 2} undirected edges")

    # node features: degree + log-df; labels: df quartile band
    x = np.zeros((vocab, 8), np.float32)
    deg = np.bincount(ei[0], minlength=vocab).astype(np.float32)
    x[:, 0] = deg / max(deg.max(), 1)
    x[:, 1] = np.log1p(df) / np.log1p(df.max())
    x[:, 2:] = np.random.default_rng(0).standard_normal((vocab, 6)) * 0.1
    labels = np.digitize(df, np.percentile(df[df > 0], [25, 50, 75]))

    in_net = np.zeros(vocab, np.float32)
    in_net[np.unique(ei)] = 1.0                      # only network nodes count

    cfg = get_config("gin-tu")
    model = G.init_gin(cfg, torch.Generator(device=dev).manual_seed(0), 8, 4,
                       device=dev)
    opt = make_optimizer(cfg)
    step = make_train_step(cfg, lambda m, b: G.node_loss(cfg, m, b), opt)
    batch = {
        "x": torch.from_numpy(x).to(dev),
        "edge_src": torch.from_numpy(ei[0].astype(np.int32)).to(dev),
        "edge_dst": torch.from_numpy(ei[1].astype(np.int32)).to(dev),
        "labels": torch.from_numpy(labels.astype(np.int32)).to(dev),
        "label_mask": torch.from_numpy(in_net).to(dev),
    }
    state = opt.init(pytree.module_tree(model))
    last = args.steps - 1
    for s in range(args.steps):
        model, state, m = step(model, state, batch)
        if s % 10 == 0 or s == last:
            print(f"step {s:3d}  loss {float(m['loss']):.4f}  "
                  f"acc {float(m['acc']):.3f}")
    assert np.isfinite(float(m["loss"]))
    print("GIN trained on the co-occurrence network  [ok]")


if __name__ == "__main__":
    main()
