"""The generators repeat for a given ``--seed`` and move with it."""
from __future__ import annotations

import json

import numpy as np
import torch

from conftest import ROOT, SEED
from portbench import corpus
from portbench.systems import cooc

CORPUS = {"mean_len": 12.0, "max_len": 64, "zipf_a": 1.15, "zipf_shift": 2.7}


def _docs(seed, n=500, v=256):
    return corpus.draw_docs(n, v, CORPUS, corpus.generator(seed, "docs",
                                                           "cpu"))


def test_documents_repeat_for_a_seed():
    a, b, c = _docs(SEED), _docs(SEED), _docs(SEED + 1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.dtype == torch.int32 and a.shape == (500, 64)
    lens = (a >= 0).sum(1)
    assert int(lens.min()) >= 1 and int(lens.max()) <= 64
    # the -1 padding is a suffix of each row
    assert bool(((a >= 0).int().diff(dim=1) <= 0).all())


def test_seeds_beyond_32_bits():
    a = _docs(2 ** 33 + 5, n=50)
    assert torch.equal(a, _docs(2 ** 33 + 5, n=50))


def test_open_loop_requests_repeat():
    traffic = json.loads((ROOT / "portbench" / "traffic" /
                          "head-tail-d3.json").read_text())
    traffic.update(head_terms=16, tail_df=[1, 8])
    df = corpus.doc_freq(_docs(SEED, n=2000), 256)
    d1, s1 = cooc.open_requests(traffic, df, SEED, 2.0)
    d2, s2 = cooc.open_requests(traffic, df, SEED, 2.0)
    d3, s3 = cooc.open_requests(traffic, df, SEED + 1, 2.0)
    assert np.array_equal(d1, d2) and np.array_equal(s1, s2)
    assert not np.array_equal(d1, d3)
    # a fixed count of arrivals whatever the seed, inside the window
    assert len(d1) == len(d3) == round(traffic["rate_per_s"] * 2.0)
    assert d1.min() >= 0 and d1.max() < 2.0 and np.all(np.diff(d1) >= 0)
    head, tail = corpus.head_tail_pools(df, 16, [1, 8])
    assert np.isin(s1[0::2], head).all() and np.isin(s1[1::2], tail).all()


def test_batch_and_stream_draws_repeat():
    cfg = {"vocab_size": 256, "corpus": CORPUS, "n_docs": 100}
    traffic = {"queries": 8, "seeds_per_query": 4,
               "ingest": {"every_s": 1.0, "docs": 32}}
    def draw(seed):
        return cooc.batch_seeds(cfg, traffic,
                                corpus.generator(seed, "seeds", "cpu"), 3)
    a = draw(SEED)
    assert a.shape == (3, 8, 4)
    assert np.array_equal(a, draw(SEED))
    assert not np.array_equal(a, draw(SEED + 1))
    s = cooc.stream_docs(cfg, traffic, SEED, 3.0, "cpu")
    assert s.shape == (32 * 4, 64)
    assert torch.equal(s, cooc.stream_docs(cfg, traffic, SEED, 3.0, "cpu"))


def test_streams_of_one_seed_differ():
    assert corpus.stream_seed(SEED, "docs") != corpus.stream_seed(SEED,
                                                                  "seeds")
    assert corpus.stream_seed(SEED, "docs") != corpus.stream_seed(SEED + 1,
                                                                  "docs")
