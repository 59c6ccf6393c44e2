"""The port's MinHash / LSH sketch layer against the JAX reference.

The same seeded numpy inputs go through ``repro.core.sketch`` and
``repro_torch.core.sketch`` on the CPU.  Every comparison is exact: hash
coefficients, the (bands, rows) optimizer over a grid, banding, padding,
the gathered top-k (values, ids and tie order), and the signatures slot
for slot, the port's int32 patterns viewed as uint32.  The signature
algebra (any partition of the slots, merged in any order, equals the
whole-index signature) is checked on the port as ``tests/test_sketch.py``
checks it on the reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core import sketch as JS  # noqa: E402
from repro_torch.core import sketch as TS  # noqa: E402
from repro_torch.core.inverted_index import to_uint32  # noqa: E402


def _corpus(rng, n_docs, vocab):
    return [rng.integers(0, vocab, rng.integers(0, 8)).tolist()
            for _ in range(n_docs)]


def _pair(docs, vocab, capacity=None):
    return (T.pack_docs(docs, vocab, capacity=capacity, device="cpu"),
            J.pack_docs(docs, vocab, capacity=capacity))


def _ref_sigs(packed, a, b):
    return np.asarray(JS.minhash_signatures(packed, jnp.asarray(a),
                                            jnp.asarray(b)))


@pytest.mark.parametrize("num_perm,seed", [(1, 0), (16, 3), (128, 0),
                                           (77, 12345)])
def test_hash_coefficients_equal_the_reference(num_perm, seed):
    a, b = TS.hash_coefficients(num_perm, seed)
    ja, jb = JS.hash_coefficients(num_perm, seed)
    assert a.dtype == b.dtype == np.uint32
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    assert np.all(a % 2 == 1)
    with pytest.raises(ValueError):
        TS.hash_coefficients(0)


def test_lsh_params_equal_the_reference_over_a_grid():
    for t in (0.05, 0.2, 0.5, 0.7, 0.95):
        for p in (1, 2, 7, 16, 32, 64, 128):
            assert TS.lsh_params(t, p) == JS.lsh_params(t, p), (t, p)
    assert TS.lsh_params(0.5, 128) == (26, 4)
    for bad in (0.0, 1.0, -0.5):
        with pytest.raises(ValueError):
            TS.lsh_params(bad, 16)
    with pytest.raises(ValueError):
        TS.lsh_params(0.5, 0)
    s = np.linspace(0, 1, 11)
    np.testing.assert_array_equal(TS.lsh_probabilities(s, 6, 2),
                                  JS.lsh_probabilities(s, 6, 2))


@pytest.mark.parametrize("seed", range(3))
def test_signatures_equal_the_reference_slot_for_slot(seed):
    """Whole-index and block signatures, a term with no postings
    (SIG_EMPTY), and hashes with bit 31 set."""
    rng = np.random.default_rng(seed)
    vocab = 40
    docs = _corpus(rng, 70, vocab - 1)       # term vocab-1 never occurs
    t_idx, j_idx = _pair(docs, vocab)
    a, b = TS.hash_coefficients(16, seed)
    want = _ref_sigs(j_idx.packed, a, b)
    got = to_uint32(TS.minhash_signatures(t_idx.packed, a, b))
    np.testing.assert_array_equal(got, want)
    assert (want[vocab - 1] == TS.SIG_EMPTY).all()
    assert (want[want != TS.SIG_EMPTY] >= 1 << 31).any()
    slots = rng.permutation(70)[:31]
    np.testing.assert_array_equal(
        to_uint32(TS.block_signatures(t_idx.packed, slots, a, b)),
        np.asarray(JS.block_signatures(j_idx.packed, slots, a, b)))
    empty = TS.block_signatures(t_idx.packed, [], a, b)
    assert empty.shape == (vocab, 16) and (to_uint32(empty)
                                           == TS.SIG_EMPTY).all()


def test_high_slot_ids_hash_like_the_reference():
    """Docs placed at slots near 2^17 of a windowed ring: the hash of
    every set bit wraps mod 2^32 as the reference's uint32 does."""
    rng = np.random.default_rng(5)
    vocab, cap = 24, 1 << 17
    t_ctx = T.QueryContext.from_docs([], vocab, capacity=cap, device="cpu")
    j_ctx = J.QueryContext.from_docs([], vocab, capacity=cap)
    for ctx in (t_ctx, j_ctx):
        ctx.ingest_docs([[]] * (cap - 40), max_len=1)
        ctx.ingest_docs(_corpus(np.random.default_rng(5), 40, vocab),
                        max_len=8)
    a, b = TS.hash_coefficients(32, int(rng.integers(0, 100)))
    slots = np.arange(cap - 40, cap)
    np.testing.assert_array_equal(
        to_uint32(TS.block_signatures(t_ctx.index.packed, slots, a, b)),
        np.asarray(JS.block_signatures(j_ctx.index.packed, slots, a, b)))


@pytest.mark.parametrize("seed,n_parts", [(0, 1), (1, 3), (2, 6), (3, 4)])
def test_partition_and_merge_order_invariance(seed, n_parts):
    rng = np.random.default_rng(seed)
    vocab, n_docs, num_perm = 40, 70, 16
    t_idx, j_idx = _pair(_corpus(rng, n_docs, vocab), vocab)
    a, b = TS.hash_coefficients(num_perm, seed=1)
    full = _ref_sigs(j_idx.packed, a, b)
    parts = [p for p in np.array_split(rng.permutation(n_docs), n_parts)
             if len(p)]
    sigs = [TS.block_signatures(t_idx.packed, p, a, b) for p in parts]
    for _ in range(3):
        order = rng.permutation(len(sigs))
        merged = TS.merge_signatures([sigs[i] for i in order], vocab,
                                     num_perm)
        np.testing.assert_array_equal(to_uint32(merged), full)
    empty = TS.merge_signatures([], vocab, num_perm)
    np.testing.assert_array_equal(
        to_uint32(empty), np.asarray(JS.merge_signatures([], vocab,
                                                         num_perm)))


def test_merge_is_unsigned():
    """SIG_EMPTY (the pattern -1) loses to every hash, and a hash with
    bit 31 set loses to one without: a signed min would get both wrong."""
    x = torch.tensor([[-1, -5, 7]], dtype=torch.int32)
    y = torch.tensor([[3, 9, -2]], dtype=torch.int32)
    got = TS.merge_signatures([x, y], 1, 3)
    assert got.tolist() == [[3, 9, 7]]


def _random_sigs(rng, v, p, alphabet):
    return rng.integers(0, alphabet, (v, p)).astype(np.uint32)


@pytest.mark.parametrize("v,row_tile,seed", [(50, 8, 0), (130, 64, 1),
                                             (257, 128, 2)])
def test_candidate_columns_equal_the_reference(v, row_tile, seed):
    rng = np.random.default_rng(seed)
    sigs = _random_sigs(rng, v, 12, 3)
    active = rng.random(v) < 0.8
    got = TS.candidate_columns(sigs, b=4, r=3, active=active,
                               row_tile=row_tile)
    want = JS.candidate_columns(sigs, b=4, r=3, active=active,
                                row_tile=row_tile)
    assert got[1] == want[1] > 0
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        TS.candidate_columns(sigs, b=5, r=3, active=active, row_tile=8)


@pytest.mark.parametrize("c,vocab", [(1, 1), (1, 520), (64, 64), (65, 300),
                                     (200, 257), (400, 520), (300, 300)])
def test_pad_candidates_equal_the_reference(c, vocab):
    cols = np.arange(c, dtype=np.int32)
    np.testing.assert_array_equal(TS.pad_candidates(cols, vocab),
                                  JS.pad_candidates(cols, vocab))


@pytest.mark.parametrize("seed,c,k", [(0, 24, 5), (1, 3, 10), (2, 1, 1),
                                      (3, 16, 16), (4, 10, 4)])
def test_gathered_top_k_equals_the_reference(seed, c, k):
    """Values from {0, 1, 2}, so most rows tie; C < k pads weight -1 and
    id 0; pad columns (-1) map to id 0."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 3, size=(4, c)).astype(np.int32)
    cand = np.sort(rng.choice(200, size=c, replace=False)).astype(np.int32)
    cand[-1:] = -1 if c > 2 else cand[-1:]
    w, ids = TS.gathered_top_k(torch.from_numpy(counts),
                               torch.from_numpy(cand), k)
    jw, jids = JS.gathered_top_k(jnp.asarray(counts), jnp.asarray(cand), k)
    assert w.dtype == ids.dtype == torch.int32
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def test_estimate_recall_equals_the_reference():
    rng = np.random.default_rng(0)
    sigs = _random_sigs(rng, 30, 16, 2)
    src, dst = rng.integers(0, 30, 50), rng.integers(0, 30, 50)
    valid = rng.random(50) < 0.7
    assert (TS.estimate_recall(sigs, src, dst, valid, b=4, r=4)
            == JS.estimate_recall(sigs, src, dst, valid, b=4, r=4))
    assert TS.estimate_recall(sigs, src, dst, np.zeros(50, bool), b=4,
                              r=4) == 1.0
