"""The plain reference equals the program's answers on the CPU, on small
corpora: queries (values and tie order), whole-network rows, evicted
blocks, and the window's live documents."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import SEED
from portbench import corpus, reference
from portbench.systems import cooc

CORPUS = {"mean_len": 12.0, "max_len": 64, "zipf_a": 1.15, "zipf_shift": 2.7}


def _docs(n, v, seed=SEED, stream="docs"):
    return corpus.draw_docs(n, v, CORPUS, corpus.generator(seed, stream,
                                                           "cpu"))


def _program(docs, v):
    cfg = {"vocab_size": v, "window": None}
    return cooc._context(cfg, docs, "cpu")


@pytest.mark.parametrize("n,v,depth,topk,beam", [
    (2000, 256, 3, 16, 32), (3000, 512, 2, 16, 16), (1500, 2048, 3, 4, 6)])
def test_bfs_equals_the_program(n, v, depth, topk, beam):
    from repro_torch.serve import CoocEngine
    docs = _docs(n, v)
    ctx = _program(docs, v)
    df = corpus.doc_freq(docs, v)
    seeds = corpus.head_tail_seeds(df, 24, 16, [1, 8], corpus.rng(SEED, "s"))
    eng = CoocEngine(ctx, device="cpu", depth=depth, topk=topk, beam=beam,
                     q_batch=8, method="gemm")
    got = [cooc._edges(f.result().network)
           for f in [eng.submit([int(s)]) for s in seeds]]
    want = reference.bfs(reference.Index(docs, v), [int(s) for s in seeds],
                         depth=depth, topk=topk, beam=beam)
    assert got == want
    assert sum(len(w) for w in want) > 0


def test_bfs_of_many_seeds_equals_the_program():
    """Queries of four seeds drawn by term frequency, repeats among them,
    as the batch cell sends them."""
    from repro_torch.serve import CoocEngine
    v = 512
    cfg = {"vocab_size": v, "corpus": CORPUS}
    docs = _docs(3000, v)
    seeds = cooc.batch_seeds(cfg, {"queries": 16, "seeds_per_query": 4},
                             corpus.generator(SEED, "seeds", "cpu"), 1)[0]
    assert any(len(set(q)) < 4 for q in seeds.tolist())
    eng = CoocEngine(_program(docs, v), device="cpu", depth=2, topk=16,
                     beam=16, q_batch=16, method="gemm")
    got = [cooc._edges(f.result().network)
           for f in [eng.submit(cooc._query(q)) for q in seeds]]
    want = reference.bfs(reference.Index(docs, v),
                         [cooc._query(q) for q in seeds], depth=2, topk=16,
                         beam=16)
    assert got == want
    assert all(len(w) > 0 for w in want)


def test_bfs_within_a_document_range():
    """A query over documents [lo, hi) equals the program's over an index
    of those documents alone."""
    from repro_torch.serve import CoocEngine
    v = 256
    docs = _docs(2000, v)
    lo, hi = 300, 1700
    ctx = _program(docs[lo:hi], v)
    df = corpus.doc_freq(docs[lo:hi], v)
    seeds = corpus.head_tail_seeds(df, 8, 8, [1, 8], corpus.rng(SEED, "r"))
    eng = CoocEngine(ctx, device="cpu", depth=2, topk=8, beam=8,
                     q_batch=8, method="gemm")
    got = [cooc._edges(f.result().network)
           for f in [eng.submit([int(s)]) for s in seeds]]
    want = reference.bfs(reference.Index(docs, v), [int(s) for s in seeds],
                         depth=2, topk=8, beam=8, lo=[lo] * 8, hi=[hi] * 8)
    assert got == want


def test_network_rows_equal_the_program():
    from repro_torch.core import materialize
    v, k = 256, 8
    docs = _docs(2000, v)
    net = materialize(_program(docs, v), k=k, method="pallas",
                      use_cache=False)
    terms = np.arange(v)
    dst, wt = reference.network_rows(reference.Index(docs, v), terms, k)
    assert np.array_equal(net.dst.numpy().reshape(v, k), dst)
    assert np.array_equal(net.weight.numpy().reshape(v, k), wt)
    assert (wt > 0).any()


def test_cold_blocks_and_live_range_equal_the_program():
    """The window's evicted blocks, as the program spills them, equal the
    reference's bitmaps; its live documents are live_range's."""
    from repro_torch.core import PackedIndex, QueryContext, decode_block
    v, window, block = 128, 700, 64
    docs = _docs(window + 5 * block, v)
    store = {}
    ctx = QueryContext(PackedIndex(torch.zeros(((window + 31) // 32, v),
                                               dtype=torch.int32),
                                   torch.zeros(v, dtype=torch.int32), 0),
                       device="cpu", window=window, cold_store=store)
    for lo in range(0, window, block):
        part = docs[lo:min(lo + block, window)]
        ctx.ingest(part, torch.ones(part.shape[0], dtype=torch.bool))
    assert ctx.live_docs == window and not store
    for j in range(5):
        part = docs[window + j * block:window + (j + 1) * block]
        ctx.ingest(part, torch.ones(block, dtype=torch.bool))
        lo, hi = cooc.live_range(window, block, window, j + 1)
        assert hi - lo == ctx.live_docs
    starts = list(range(0, window, block))
    for key, s in zip(sorted(store), starts):
        blk = decode_block(store[key])
        packed, df = reference.cold_block(docs[s:min(s + block, window)], v)
        assert np.array_equal(blk.packed, packed)
        assert np.array_equal(blk.doc_freq, df)
    assert len(store) == len([s for s in starts if s < lo])


def test_control_changes_answers_only_where_counts_pass_float16():
    """The float16 control equals the exact reference on counts that
    float16 holds exactly and departs where they are larger."""
    v = 64
    docs = _docs(6000, v)
    idx = reference.Index(docs, v)
    terms = np.arange(v)
    exact = reference.network_rows(idx, terms, 8)
    low = reference.network_rows(idx, terms, 8, precision="float16")
    small = (exact[1] < 2048).all(1)
    assert small.any() and (~small).any()
    assert np.array_equal(exact[1][small], low[1][small])
    assert not np.array_equal(exact[1][~small], low[1][~small])
