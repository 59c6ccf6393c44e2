"""The roofline count's arithmetic, on frontiers worked out by hand."""
from __future__ import annotations

import pytest
import torch

from portbench import reference, roofline

RATES = {"popcount_ops_per_s": 1e12, "int8_ops_per_s": 1e15,
         "hbm_bytes_per_s": 1e12}


def _docs(rows):
    """Documents as (N, M) term ids padded with -1."""
    m = max(len(r) for r in rows)
    return torch.tensor([r + [-1] * (m - len(r)) for r in rows])


def test_frontier_words_of_a_hand_made_corpus():
    """Term 0 is in documents 0, 1, 33 and 70 (words 0, 1 and 2); term 1
    in documents 1 and 70; term 2 in document 33.  A depth-2 query on
    seed 0: level 0 has one row over docs {0, 1, 33, 70}, three nonzero
    words; its edges are 1 (weight 2) and 2 (weight 1); level 1's rows are
    {1, 70} (words 0 and 2) and {33} (word 1)."""
    rows = [[] for _ in range(96)]
    for d in (0, 1, 33, 70):
        rows[d].append(0)
    for d in (1, 70):
        rows[d].append(1)
    rows[33].append(2)
    rows = [r or [3] for r in rows]
    index = reference.Index(_docs(rows), 4)
    stats = []
    edges = reference.bfs(index, [0, 0], depth=2, topk=2, beam=4,
                          stats=stats, groups=[0, 1],
                          word_of=lambda d: d // 32)
    assert edges[0][:2] == [(0, 1, 2), (0, 2, 1)]
    by = {(s["group"], s["level"]): s for s in stats}
    assert by[(0, 0)] == {"group": 0, "level": 0, "rows": 1,
                          "nonzero_words": 3, "active_words": 3}
    assert by[(1, 1)] == {"group": 1, "level": 1, "rows": 2,
                          "nonzero_words": 3, "active_words": 3}


def test_two_queries_in_one_batch_share_their_words():
    rows = [[0, 1] if d in (0, 40) else [2] for d in range(64)]
    index = reference.Index(_docs(rows), 3)
    stats = []
    reference.bfs(index, [0, 1], depth=1, topk=1, beam=1, stats=stats,
                  groups=[0, 0], word_of=lambda d: d // 32)
    assert stats == [{"group": 0, "level": 0, "rows": 2,
                      "nonzero_words": 4, "active_words": 2}]


def test_least_time_takes_the_better_count_and_the_larger_bound():
    # popcount: 1,000 words x 100 terms / 1e12 = 1e-7 s; int8: 2 x 10
    # rows x 1e6 docs x 100 / 1e15 = 2e-6 s; bytes: (4 x 50 x 100 + 4 x
    # 20 + 8 x 10 x 4) / 1e12 = 2.04e-8 s
    t, what = roofline.least_s(rows=10, nonzero_words=1000, words=50,
                               mask_words=20, n_docs=10 ** 6, vocab=100,
                               k=4, rates=RATES)
    assert what == "popcount" and t == pytest.approx(1e-7)
    # dense rows: the int8 product is the better count
    t, what = roofline.least_s(rows=1, nonzero_words=10 ** 6, words=0,
                               mask_words=0, n_docs=100, vocab=100, k=1,
                               rates=RATES)
    assert what == "int8" and t == pytest.approx(2e-11)
    # few operations on many words: bytes bound it
    t, what = roofline.least_s(rows=1, nonzero_words=1, words=10 ** 6,
                               mask_words=0, n_docs=100, vocab=100, k=1,
                               rates=RATES)
    assert what == "bytes" and t == pytest.approx((4e8 + 8) / 1e12)


def test_network_work():
    rows = [[0, 1], [0], [1, 2]] + [[3]] * 61
    index = reference.Index(_docs(rows), 5)
    assert reference.network_work(index, lambda d: d // 32) == \
        {"rows": 4, "nonzero_words": 5, "words": 2}


def test_peaks_have_sources():
    import json
    raw = json.loads(roofline.PEAKS_FILE.read_text())
    for name in ("hbm_bytes_per_s", "int8_ops_per_s", "popcount_ops_per_s"):
        assert raw[name]["value"] > 0 and raw[name]["source"]
    assert roofline.peaks()["popcount_ops_per_s"] == 132 * 16 * 1.98e9
