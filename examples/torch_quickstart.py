"""Quickstart on the PyTorch port: text in, term-string co-occurrence
network out, and a three-way agreement check between the algorithms.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port of ``examples/quickstart.py``, through ``repro_torch`` alone; it
runs on the GPU unless ``--device cpu`` is given.

1. build a string-level CoocIndex over a tiny corpus (tokeniser + lexicon
   + packed inverted index + plan-aware engine, one facade),
2. query it: heaviest edges around a seed term, as term strings,
3. cross-check against the traversal baseline (Algorithm 1) and the
   paper-faithful host BFS (Algorithm 3),
4. ingest fresh documents and watch the next query reflect them.
"""
import argparse

from repro_torch.api import CoocIndex
from repro_torch.core import (
    bfs_construct_host_fast,
    build_host_index,
    traversal_construct_host,
)
from repro_torch.data import build_lexicon

CORPUS = [
    "graph neural networks learn node embeddings from graph structure",
    "co-occurrence networks reveal semantic relationships in text corpora",
    "inverted index maps keywords to documents for fast retrieval",
    "breadth first search expands the network frontier level by level",
    "keyword co-occurrence networks support text mining and retrieval",
    "the inverted index makes co-occurrence network construction fast",
    "semantic networks and knowledge graphs organise scientific keywords",
    "fast retrieval of documents uses the inverted index keywords",
    "text mining extracts keywords and builds co-occurrence networks",
    "network construction from an inverted index runs in real time",
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # the facade: tokenise + index + serve, one object
    idx = CoocIndex.from_texts(CORPUS, device=args.device, depth=2, topk=6,
                               beam=8, q_batch=4)
    print(f"corpus: {idx.n_docs} docs, lexicon {idx.n_terms} terms")

    edges = idx.network(["networks"])
    print(f"optimized BFS (seed='networks'): {len(edges)} edges")

    # cross-check 1 — the paper-faithful host implementation (Algorithm 3)
    lex, docs = build_lexicon(CORPUS)
    hidx = build_host_index(docs, len(lex))
    host = {}
    for s, d, w in bfs_construct_host_fast(hidx, [lex.lookup("networks")],
                                           depth=2, topk=6, beam=8):
        k = (min(s, d), max(s, d))
        host[k] = max(host.get(k, 0), w)
    host_str = {(lex.id_to_term[a], lex.id_to_term[b]): w
                for (a, b), w in host.items()}
    assert edges == host_str, "facade and host forms must agree"
    print("facade (TPU form) and paper host form agree  [ok]")

    # cross-check 2 — every edge weight equals the exact traversal count
    trav = traversal_construct_host(docs, len(lex))
    for (a, b), w in edges.items():
        key = (min(lex.lookup(a), lex.lookup(b)),
               max(lex.lookup(a), lex.lookup(b)))
        assert trav.get(key) == w, (a, b, w, trav.get(key))
    print("edge weights match the exact traversal counts  [ok]")

    print("\nheaviest edges around 'networks':")
    for a, b, w in idx.top(["networks"], limit=8):
        print(f"  {a:>14} -- {b:<14} (co-occurs in {w} docs)")

    # real-time ingest: new docs (and new TERMS) visible to the next query
    idx.add_documents(["inverted index networks accelerate retrieval"] * 2)
    grown = idx.network(["accelerate"], depth=1)
    assert grown[("networks", "accelerate")] == 2
    print(f"\nafter ingesting 2 fresh docs, 'accelerate' (a brand-new term) "
          f"has {len(grown)} edges — real-time visibility  [ok]")


if __name__ == "__main__":
    main()
