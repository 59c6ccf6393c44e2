"""The port's bit-packed index and query context against the JAX reference.

The same numpy inputs (fixed seeds) go through ``repro.core`` and
``repro_torch.core`` on the CPU; bit patterns (uint32 viewed as int32),
``doc_freq`` and ``n_docs`` must be identical, and a port context rebuilt
from the reference's serialised state must answer exactly like it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.snapshot import context_state  # noqa: E402
from repro.data import synthetic_csl  # noqa: E402
from repro_torch.core.inverted_index import to_uint32  # noqa: E402


def _docs(n, v, seed, max_len=9):
    """Random docs with repeated ids and ids outside [0, v)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(-2, v + 3, rng.integers(0, max_len)).tolist()
            for _ in range(n)]


def _same_index(t_idx, j_idx):
    np.testing.assert_array_equal(to_uint32(t_idx.packed),
                                  np.asarray(j_idx.packed))
    np.testing.assert_array_equal(t_idx.doc_freq.numpy(),
                                  np.asarray(j_idx.doc_freq))
    assert t_idx.n_docs == int(j_idx.n_docs)


@pytest.mark.parametrize("n,v,cap", [(70, 40, None), (33, 9, 200),
                                     (0, 5, 64), (1, 1, None)])
def test_pack_docs_bit_identical(n, v, cap):
    docs = _docs(n, v, seed=n + v)
    _same_index(T.pack_docs(docs, v, capacity=cap, device="cpu"),
                J.pack_docs(docs, v, capacity=cap))


def _block(n, m, v, seed):
    rng = np.random.default_rng(seed)
    terms = rng.integers(-1, v + 2, (n, m)).astype(np.int32)
    valid = rng.random(n) < 0.8
    return terms, valid


def test_ingest_appends_bit_identical():
    base = _docs(40, 30, seed=1)
    t_idx = T.pack_docs(base, 30, capacity=160, device="cpu")
    j_idx = J.pack_docs(base, 30, capacity=160)
    for seed in (2, 3):
        terms, valid = _block(25, 6, 30, seed)
        t_idx = T.ingest(t_idx, torch.from_numpy(terms),
                         torch.from_numpy(valid))
        j_idx = J.ingest(j_idx, jnp.asarray(terms), jnp.asarray(valid))
        _same_index(t_idx, j_idx)


def test_ingest_at_explicit_slots_bit_identical():
    t_idx = T.pack_docs(_docs(10, 20, seed=4), 20, capacity=96, device="cpu")
    j_idx = J.pack_docs(_docs(10, 20, seed=4), 20, capacity=96)
    terms, valid = _block(12, 5, 20, seed=5)
    slots = np.random.default_rng(6).permutation(np.arange(30, 96))[:12]
    t_idx = T.ingest_at(t_idx, torch.from_numpy(terms),
                        torch.from_numpy(valid), torch.from_numpy(slots))
    j_idx = J.ingest_at(j_idx, jnp.asarray(terms), jnp.asarray(valid),
                        jnp.asarray(slots, jnp.int32))
    _same_index(t_idx, j_idx)


def test_grow_capacity_and_vocab_bit_identical():
    docs = _docs(50, 12, seed=7)
    t_idx = T.pack_docs(docs, 12, device="cpu")
    j_idx = J.pack_docs(docs, 12)
    for cap, vocab in [(51, 12), (300, 13), (300, 100), (10, 5)]:
        t_idx = T.grow_vocab(T.grow_capacity(t_idx, cap), vocab)
        j_idx = J.grow_vocab(J.grow_capacity(j_idx, cap), vocab)
        _same_index(t_idx, j_idx)
    assert t_idx.packed.shape == (16, 192)


def test_index_algebra_matches_reference():
    docs = _docs(77, 24, seed=8)
    t_idx = T.pack_docs(docs, 24, capacity=128, device="cpu")
    j_idx = J.pack_docs(docs, 24, capacity=128)
    np.testing.assert_array_equal(to_uint32(T.empty_mask(t_idx)),
                                  np.asarray(J.empty_mask(j_idx)))
    np.testing.assert_array_equal(T.incidence_dense(t_idx).numpy(),
                                  np.asarray(J.incidence_dense(j_idx)))
    rng = np.random.default_rng(9)
    masks = rng.integers(0, 1 << 32, (5, 4), dtype=np.uint32)
    tm = T.from_uint32(masks, "cpu")
    want = np.asarray(J.doc_freq_under_batch(j_idx, jnp.asarray(masks)))
    np.testing.assert_array_equal(T.doc_freq_under_batch(t_idx, tm).numpy(),
                                  want)
    from repro.core.inverted_index import unpack_bitmap
    np.testing.assert_array_equal(
        T.unpack_bitmap(tm).numpy(),
        np.asarray(unpack_bitmap(jnp.asarray(masks), jnp.float32)))
    x = T.dense_operand(t_idx)
    assert x.dtype == torch.int8 and x.shape == (128, 24)
    np.testing.assert_array_equal(
        T.doc_freq_under_batch_gemm(tm, x).numpy(), want)
    # a vocabulary off the multiple of 8 pads zero columns, sliced off here
    t_odd = T.pack_docs(docs, 21, capacity=128, device="cpu")
    j_odd = J.pack_docs(docs, 21, capacity=128)
    x = T.dense_operand(t_odd)
    assert x.shape == (128, 24) and not x[:, 21:].any()
    np.testing.assert_array_equal(
        T.doc_freq_under_batch_gemm(tm, x)[:, :21].numpy(),
        np.asarray(J.doc_freq_under_batch(j_odd, jnp.asarray(masks))))
    slots = [0, 31, 32, 100, 127]
    np.testing.assert_array_equal(T.slots_bitmap(slots, 4),
                                  J.slots_bitmap(slots, 4))
    with pytest.raises(ValueError):
        T.slots_bitmap([128], 4)


# ---------------------------------------------------------------------------
# QueryContext
# ---------------------------------------------------------------------------


def test_context_ingest_docs_capacity_policy():
    docs = synthetic_csl(60, 32, seed=1)
    t_ctx = T.QueryContext.from_docs(docs[:20], 32, capacity=32,
                                     device="cpu")
    j_ctx = J.QueryContext.from_docs(docs[:20], 32, capacity=32)
    for ctx, err in ((t_ctx, T.CapacityError), (j_ctx, J.CapacityError)):
        with pytest.raises(err):
            ctx.ingest_docs(docs[20:], on_overflow="raise")
    assert t_ctx.epoch == j_ctx.epoch == 0
    a = t_ctx.ingest_docs(docs[20:], on_overflow="grow", scope="late")
    b = j_ctx.ingest_docs(docs[20:], on_overflow="grow", scope="late")
    np.testing.assert_array_equal(a, b)
    _same_index(t_ctx.index, j_ctx.index)
    assert t_ctx.epoch == j_ctx.epoch
    np.testing.assert_array_equal(t_ctx.live_slots(), j_ctx.live_slots())
    np.testing.assert_array_equal(to_uint32(t_ctx.scope("late")),
                                  np.asarray(j_ctx.scope("late")))
    with pytest.raises(ValueError, match="max_len"):
        t_ctx.ingest_docs([[1] * 5], max_len=4, on_overflow="grow")


def test_context_artifacts_match_reference():
    docs = synthetic_csl(100, 21, seed=2)
    t_ctx = T.QueryContext.from_docs(docs, 21, device="cpu")
    j_ctx = J.QueryContext.from_docs(docs, 21)
    pt, jpt = t_ctx.packed_t_pad(), np.asarray(j_ctx.packed_t_pad())
    assert pt.shape == (24, 128) and jpt.shape == (24, 128)
    np.testing.assert_array_equal(to_uint32(pt), jpt)
    np.testing.assert_array_equal(to_uint32(t_ctx.packed_t()),
                                  np.asarray(j_ctx.packed_t()))
    x = t_ctx.x_dense()
    assert x.dtype == torch.int8 and x.shape == (128, 24)
    np.testing.assert_array_equal(x[:, :21].numpy(),
                                  np.asarray(j_ctx.x_dense(), np.int8))
    assert not x[:, 21:].any()
    assert t_ctx.packed_t_pad() is pt            # cached within an epoch
    assert (t_ctx.full_mask() == -1).all()       # 0xFFFFFFFF as int32
    np.testing.assert_array_equal(to_uint32(t_ctx.full_mask()),
                                  np.asarray(j_ctx.full_mask()))
    t_ctx.ingest_docs([[1, 2]])
    assert t_ctx.packed_t_pad() is not pt        # rebuilt after an ingest
    assert set(t_ctx.operands("fused")) == {"packed_t_pad"}


def test_context_scopes_and_artifact_cache():
    ctx = T.QueryContext.from_docs(synthetic_csl(64, 16, seed=3), 16,
                                   device="cpu")
    ctx.tag_scope("a", [1, 2])
    ctx.tag_scope("a", [40])
    assert ctx.scope_version("a") == 2
    ctx.define_scope("a", [1, 2, 40])            # unchanged: no bump
    assert ctx.scope_version("a") == 2
    np.testing.assert_array_equal(to_uint32(ctx.scope("a")),
                                  T.slots_bitmap([1, 2, 40], 2))
    assert ctx.scope_names() == ("a",)
    ctx.drop_scope("a")
    with pytest.raises(KeyError):
        ctx.scope("a")
    ctx.store_artifact(("k",), 7)
    assert ctx.cached_artifact(("k",)) == 7
    assert ctx.cached_artifact(("k",), version=1) is None
    ctx.ingest_docs([[3]], on_overflow="grow")
    assert ctx.cached_artifact(("k",)) is None   # stale epoch


def test_context_vocab_grow_and_shrink():
    docs = synthetic_csl(40, 10, seed=4)
    t_ctx = T.QueryContext.from_docs(docs, 10, device="cpu")
    j_ctx = J.QueryContext.from_docs(docs, 10)
    for ctx in (t_ctx, j_ctx):
        ctx.grow_vocab(33)
    _same_index(t_ctx.index, j_ctx.index)
    assert t_ctx.epoch == j_ctx.epoch == 1
    t_ctx.shrink_vocab(10)
    j_ctx.shrink_vocab(10)
    _same_index(t_ctx.index, j_ctx.index)
    with pytest.raises(ValueError, match="hold postings"):
        t_ctx.shrink_vocab(3)


def test_context_refuses_unported_modes():
    idx = T.pack_docs([[0]], 2, device="cpu")
    for kw in ({"window": 8}, {"cold_store": {}}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            T.QueryContext(idx, device="cpu", **kw)


def test_context_from_state_answers_like_the_reference():
    """The reference context's serialised state, carried into the port,
    gives identical bits, scopes and query answers."""
    docs = synthetic_csl(300, 48, seed=5)
    j_ctx = J.QueryContext.from_docs(docs[:200], 48, capacity=320)
    j_ctx.ingest_docs(docs[200:], scope="recent")
    j_ctx.tag_scope("odd", np.arange(1, 300, 2))
    t_ctx = T.context_from_state(*context_state(j_ctx), device="cpu")
    _same_index(t_ctx.index, j_ctx.index)
    assert t_ctx.epoch == j_ctx.epoch and t_ctx.n_blocks == j_ctx.n_blocks
    np.testing.assert_array_equal(t_ctx.live_slots(), j_ctx.live_slots())
    assert t_ctx.scope_names() == j_ctx.scope_names()
    for name in t_ctx.scope_names():
        assert t_ctx.scope_version(name) == j_ctx.scope_version(name)
    for scope in (None, "recent", "odd"):
        kw = dict(seeds=(0, 5), depth=2, topk=4, beam=8, method="popcount",
                  scope=scope)
        assert (T.construct(t_ctx, T.QuerySpec(**kw)).edges()
                == J.construct(j_ctx, J.QuerySpec(**kw)).edges())
