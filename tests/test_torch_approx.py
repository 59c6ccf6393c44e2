"""The port's approximate (sketch-pruned) materialization against the JAX
reference, the non-mesh cases of ``tests/test_differential.py``'s
``TestApproxMaterialize``.

The same seeded numpy corpora go through ``repro.core.materialize`` and
``repro_torch.core.materialize`` with ``mode="approx"`` on the CPU.  The
``V * k`` edge slots (src, dst, weight, valid), ``recall_estimate`` and
``stats`` must be identical for all four count methods, unscoped,
windowed and ``scope="all-time"``; the incremental signatures must equal
a from-scratch hash across ingest, eviction and vocabulary growth.  Every
comparison is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.api import CoocIndex as JIndex  # noqa: E402
from repro.core import sketch as JS  # noqa: E402
from repro_torch.api import CoocIndex as TIndex  # noqa: E402
from repro_torch.core import sketch as TS  # noqa: E402
from repro_torch.core.inverted_index import to_uint32  # noqa: E402

METHODS = ("gemm", "popcount", "pallas", "fused")


def _clustered_corpus(vocab, n_docs, cluster, density, n_noise, seed):
    """The reference harness's corpus: docs drawn from ``vocab //
    cluster`` term communities, each term of one community kept with
    probability ``density``, plus ``n_noise`` uniform noise terms."""
    rng = np.random.default_rng(seed)
    n_cl = vocab // cluster
    docs = []
    for _ in range(n_docs):
        c = int(rng.integers(0, n_cl))
        base = np.arange(c * cluster, (c + 1) * cluster)
        keep = base[rng.random(cluster) < density]
        noise = rng.integers(0, vocab, size=n_noise)
        docs.append(sorted(set(map(int, keep)) | set(map(int, noise))))
    return docs


def _same_approx(t_net, j_net, what=""):
    assert isinstance(t_net, T.ApproxCoocNetwork), what
    for field in ("src", "dst", "weight", "valid"):
        np.testing.assert_array_equal(
            getattr(t_net, field).numpy(),
            np.asarray(getattr(j_net, field)), err_msg=f"{what}/{field}")
    assert t_net.recall_estimate == float(j_net.recall_estimate), what
    assert tuple(t_net.stats) == tuple(j_net.stats), what
    assert t_net.stats.tiles_fraction == j_net.stats.tiles_fraction


def _pair(docs, vocab, **kw):
    return (T.QueryContext.from_docs(docs, vocab, device="cpu", **kw),
            J.QueryContext.from_docs(docs, vocab, **kw))


def test_default_knobs_on_a_clustered_corpus():
    """The reference's acceptance cell (V 384, k 8, threshold 0.5, 128
    permutations): equal slots, estimate and stats; the pruning bites;
    every emitted weight is the exact pair count; warm hits the cache."""
    vocab, k = 384, 8
    docs = _clustered_corpus(vocab, 500, 16, 0.9, 1, seed=0)
    t_ctx, j_ctx = _pair(docs, vocab)
    net = T.materialize(t_ctx, k=k, mode="approx", method="popcount")
    _same_approx(net, J.materialize(j_ctx, k=k, mode="approx",
                                    method="popcount"), "default")
    assert net.stats.tiles_fraction <= 0.5
    assert net.stats.candidate_pairs > 0
    assert net.stats.bands == 26 and net.stats.rows_per_band == 4
    assert net.max_edges == vocab * k
    assert net.num_edges() == int(net.valid.sum()) > 0
    exact = T.materialize(t_ctx, k=vocab, method="popcount")
    full = {(int(s), int(d)): int(w) for s, d, w, o in zip(
        exact.src, exact.dst, exact.weight, exact.valid) if o}
    for s, d, w, o in zip(net.src, net.dst, net.weight, net.valid):
        if o:
            assert full[(int(s), int(d))] == int(w)
    assert T.materialize(t_ctx, k=k, mode="approx", method="popcount") \
        is net


@pytest.mark.parametrize("seed", [0, 1])
def test_four_methods_equal_the_reference(seed):
    vocab = 256
    docs = _clustered_corpus(vocab, 250, 16, 0.8, 1, seed)
    t_ctx, j_ctx = _pair(docs, vocab)
    for method in METHODS:
        _same_approx(
            T.materialize(t_ctx, k=6, mode="approx", num_perm=64,
                          method=method),
            J.materialize(j_ctx, k=6, mode="approx", num_perm=64,
                          method=method), method)


def test_knobs_and_a_bare_index():
    """threshold, num_perm and sketch_seed thread through; a bare packed
    index sketches itself whole."""
    vocab = 192
    docs = _clustered_corpus(vocab, 200, 12, 0.7, 2, seed=4)
    t_ctx, j_ctx = _pair(docs, vocab)
    for kw in (dict(threshold=0.7, num_perm=32),
               dict(threshold=0.3, num_perm=16, sketch_seed=9)):
        _same_approx(T.materialize(t_ctx, k=5, mode="approx", **kw),
                     J.materialize(j_ctx, k=5, mode="approx", **kw),
                     str(kw))
    _same_approx(
        T.materialize(t_ctx.index, k=5, mode="approx", num_perm=32,
                      method="pallas", row_tile=64),
        J.materialize(j_ctx.index, k=5, mode="approx", num_perm=32,
                      method="pallas", row_tile=64), "bare")


def test_k_above_the_candidates_pads_like_the_reference():
    """k larger than a tile's candidate width: -1/0 padding, no edge."""
    vocab = 64
    docs = _clustered_corpus(vocab, 60, 8, 0.9, 0, seed=2)
    t_ctx, j_ctx = _pair(docs, vocab)
    for method in ("gemm", "pallas"):
        _same_approx(
            T.materialize(t_ctx, k=80, mode="approx", num_perm=16,
                          method=method),
            J.materialize(j_ctx, k=80, mode="approx", num_perm=16,
                          method=method), method)


@pytest.mark.parametrize("method", METHODS)
def test_windowed_and_all_time_equal_the_reference(method):
    """A windowed context with a cold store: the live approx network and
    the all-time one (the stacked live + cold index, re-sketched)."""
    vocab = 128
    docs = _clustered_corpus(vocab, 240, 16, 0.85, 1, seed=3)
    t_ctx, j_ctx = _pair([], vocab, window=100, cold_store={})
    for lo in range(0, len(docs), 40):
        np.testing.assert_array_equal(
            t_ctx.ingest_docs(docs[lo:lo + 40], max_len=24),
            j_ctx.ingest_docs(docs[lo:lo + 40], max_len=24))
    assert t_ctx.cold_blocks() > 0
    for scope in (None, "all-time"):
        _same_approx(
            T.materialize(t_ctx, k=4, mode="approx", num_perm=32,
                          method=method, scope=scope),
            J.materialize(j_ctx, k=4, mode="approx", num_perm=32,
                          method=method, scope=scope), f"{scope}")


def test_all_time_cache_key_separates_the_modes():
    """An exact all-time network, then an approx one, on one context: the
    second call must not be served the first from the cache."""
    vocab = 96
    docs = _clustered_corpus(vocab, 150, 16, 0.9, 1, seed=8)
    t_ctx, j_ctx = _pair([], vocab, window=60, cold_store={})
    for lo in range(0, len(docs), 30):
        t_ctx.ingest_docs(docs[lo:lo + 30], max_len=24)
        j_ctx.ingest_docs(docs[lo:lo + 30], max_len=24)
    T.materialize(t_ctx, k=4, scope="all-time")
    net = T.materialize(t_ctx, k=4, scope="all-time", mode="approx",
                        num_perm=32)
    _same_approx(net, J.materialize(j_ctx, k=4, scope="all-time",
                                    mode="approx", num_perm=32), "cached")
    again = T.materialize(t_ctx, k=4, scope="all-time", mode="approx",
                          num_perm=16)
    assert again is not net and again.stats.num_perm == 16


def test_incremental_signatures_match_scratch():
    """After every ingest, an eviction and a vocabulary growth, the
    merged signature equals a from-scratch hash of the live postings and
    the reference's."""
    vocab = 48
    a, b = TS.hash_coefficients(32, 0)
    rng = np.random.default_rng(0)
    t_ctx, j_ctx = _pair([], vocab, window=64)

    def check(what):
        got = to_uint32(t_ctx.term_signatures(num_perm=32))
        np.testing.assert_array_equal(
            got, to_uint32(TS.minhash_signatures(t_ctx.index.packed, a, b)),
            err_msg=what)
        np.testing.assert_array_equal(
            got, np.asarray(j_ctx.term_signatures(num_perm=32)),
            err_msg=what)

    for i in range(4):
        blk = [rng.integers(0, vocab, rng.integers(1, 8)).tolist()
               for _ in range(20)]
        t_ctx.ingest_docs(blk, max_len=8)
        j_ctx.ingest_docs(blk, max_len=8)
        check(f"ingest {i}")
    assert t_ctx.evicted_docs_total > 0
    t_ctx.retire_oldest_block()
    j_ctx.retire_oldest_block()
    check("retire")
    t_ctx.grow_vocab(vocab + 13)
    j_ctx.grow_vocab(vocab + 13)
    check("grow")
    t_ctx.shrink_vocab(vocab)
    j_ctx.shrink_vocab(vocab)
    check("shrink")


def test_an_ingest_hashes_only_the_new_block(monkeypatch):
    ctx = T.QueryContext.from_docs([], 32, device="cpu", window=200)
    rng = np.random.default_rng(1)
    for _ in range(3):
        ctx.ingest_docs([rng.integers(0, 32, 5).tolist() for _ in range(9)])
    ctx.term_signatures(num_perm=16)
    calls = []
    hash_block = TS.block_signatures
    monkeypatch.setattr(TS, "block_signatures",
                        lambda *a: calls.append(1) or hash_block(*a))
    assert ctx.term_signatures(num_perm=16) is ctx.term_signatures(
        num_perm=16)
    assert calls == []
    ctx.ingest_docs([[1, 2, 3]])
    ctx.term_signatures(num_perm=16)
    assert calls == [1]
    ctx.term_signatures(num_perm=16, seed=1)
    assert len(calls) == 5           # a second config hashes every block


def test_ingest_invalidates_the_approx_cache():
    vocab = 96
    docs = _clustered_corpus(vocab, 120, 16, 0.9, 1, 5)
    extra = _clustered_corpus(vocab, 10, 16, 0.9, 1, 6)
    ctx = T.QueryContext.from_docs([], vocab, device="cpu", window=256)
    ctx.ingest_docs(docs, max_len=24)
    warm = T.materialize(ctx, k=4, mode="approx", num_perm=32,
                         method="popcount")
    ctx.ingest_docs(extra, max_len=24)
    rebuilt = T.materialize(ctx, k=4, mode="approx", num_perm=32,
                            method="popcount")
    assert rebuilt is not warm
    fresh = J.QueryContext.from_docs(docs + extra, vocab)
    _same_approx(rebuilt, J.materialize(fresh, k=4, mode="approx",
                                        num_perm=32, method="popcount"),
                 "rebuilt")


def test_mode_and_scope_validation_errors():
    docs = _clustered_corpus(64, 40, 16, 0.8, 1, 0)
    ctx = T.QueryContext.from_docs(docs, 64, device="cpu")
    ctx.tag_scope("tag0", [0, 1, 2])
    with pytest.raises(ValueError, match="mode must be"):
        T.materialize(ctx, mode="bogus")
    with pytest.raises(ValueError, match="scoped materialization"):
        T.materialize(ctx, mode="approx", scope="tag0")
    with pytest.raises(ValueError, match="scoped materialization"):
        T.materialize(ctx, mode="approx",
                      scope_mask=np.ones((ctx.index.n_words,), np.uint32))
    with pytest.raises(ValueError, match="shard_strategy='rows'"):
        T.materialize(ctx, mode="approx", shard_strategy="rows")
    with pytest.raises(ValueError, match="threshold"):
        T.materialize(ctx, mode="approx", threshold=1.0)
    # off a mesh the strategy is ignored, as in the reference
    assert T.materialize(ctx, mode="approx", shard_strategy="cols",
                         use_cache=False).stats == T.materialize(
        ctx, mode="approx", use_cache=False).stats


def test_facade_full_network_and_stats_thread_the_mode():
    texts = [" ".join(f"w{t}" for t in doc)
             for doc in _clustered_corpus(96, 150, 16, 0.9, 1, 3)]
    t_idx = TIndex.from_texts(texts, vocab_capacity=96, device="cpu")
    j_idx = JIndex.from_texts(texts, vocab_capacity=96)
    for method in ("gemm", "pallas"):
        kw = dict(mode="approx", num_perm=64, method=method)
        approx = t_idx.full_network(4, **kw)
        assert approx and approx == j_idx.full_network(4, **kw)
        exact = t_idx.full_network(4, method=method)
        for edge, w in approx.items():
            if edge in exact:
                assert exact[edge] == w, edge
        got, want = t_idx.network_stats(4, **kw), j_idx.network_stats(4,
                                                                       **kw)
        for name, x, y in zip(want._fields, got, want):
            np.testing.assert_array_equal(x, y, err_msg=name)
