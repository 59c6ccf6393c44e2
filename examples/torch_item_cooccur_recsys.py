"""Item-item co-occurrence retrieval for recsys (users-as-documents), on
the PyTorch port.

    PYTHONPATH=src python examples/torch_item_cooccur_recsys.py [--device cpu]

The port of ``examples/item_cooccur_recsys.py``, through ``repro_torch``
alone; it runs on the GPU unless ``--device cpu`` is given.  Treat each
user's interaction history as a "document" of item ids; the
inverted-index BFS then yields, per anchor item, the items most
co-consumed with it: a candidate generator.  A SASRec model then
re-ranks those candidates (the standard retrieve -> rank split).  The
SASRec weights are drawn from a seeded ``torch.Generator``, so the
ranking differs from the reference's (which draws from a ``jax.random``
key); the retrieval is the same.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, replace
from repro_torch.core import bfs_construct, pack_docs
from repro_torch.device import resolve_device
from repro_torch.models import recsys as R


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    n_users, n_items = 4000, 1000
    # users with taste clusters -> co-consumption structure
    n_clusters = 20
    item_cluster = rng.integers(0, n_clusters, n_items)
    histories = []
    for _ in range(n_users):
        c = rng.integers(0, n_clusters)
        in_c = np.where(item_cluster == c)[0]
        k = rng.integers(3, 12)
        hist = rng.choice(in_c, size=min(k, len(in_c)), replace=False)
        if rng.random() < 0.3:                      # some cross-cluster noise
            hist = np.concatenate([hist, rng.integers(0, n_items, 2)])
        histories.append(hist.tolist())

    index = pack_docs(histories, n_items, device=dev)
    anchor = int(np.argmax(index.doc_freq.cpu().numpy()))

    # retrieve: co-consumption BFS around the anchor item
    pad = np.full((8,), -1, np.int32)
    pad[0] = anchor
    net = bfs_construct(index, torch.from_numpy(pad), depth=2, topk=16,
                        beam=16)
    src, dst, valid = (t.cpu().numpy() for t in (net.src, net.dst, net.valid))
    cand = sorted({int(d) for d, ok in zip(dst, valid) if ok}
                  | {int(s) for s, ok in zip(src, valid) if ok}
                  - {anchor})
    print(f"anchor item {anchor} (cluster {item_cluster[anchor]}): "
          f"{len(cand)} co-occurrence candidates")
    same = np.mean([item_cluster[c] == item_cluster[anchor] for c in cand])
    print(f"candidate purity (same cluster as anchor): {same:.2f}")
    assert same > 0.5, "co-occurrence retrieval should surface the cluster"

    # rank: SASRec scores the candidates against a user's history
    cfg = replace(get_config("sasrec"), n_items=n_items, seq_len=16)
    model = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    user_hist = histories[0][:16]
    seq = np.zeros((1, 16), np.int32)
    seq[0, -len(user_hist):] = user_hist
    batch = R.as_batch({"seq": seq,
                        "candidates": np.asarray(cand, np.int32)}, dev)
    scores = R.retrieval_fn(cfg, model, batch)
    order = np.argsort(-scores[0].cpu().numpy())
    print("top-5 ranked candidates:", [cand[i] for i in order[:5]])
    print("retrieve (paper's algorithm) -> rank (SASRec)  [ok]")


if __name__ == "__main__":
    main()
