"""The port's streaming tier against the JAX reference: ``retire_docs``,
ring-slot ``ingest_at``, the sliding-window ring of ``QueryContext`` and
the facade's window.

The same seeded numpy inputs go through ``repro`` and ``repro_torch`` on
the CPU.  Bits (uint32), ``doc_freq``, slot assignment, scopes, query
networks (term ids, weights and tie order, slot for slot) and the public
attributes of the ported classes must be identical.  A lockstep state
machine runs random interleavings of ingest, ``set_window``,
``retire_oldest_block`` and ``tag_scope`` on a reference and a port
context and compares them after every step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.api import CoocIndex as JIndex  # noqa: E402
from repro.core.storage import decode_block as j_decode  # noqa: E402
from repro.serve import CoocEngine as JEngine  # noqa: E402
from repro_torch.api import CoocIndex as TIndex  # noqa: E402
from repro_torch.core.inverted_index import to_uint32  # noqa: E402
from repro_torch.serve import CoocEngine as TEngine  # noqa: E402

METHODS = ("gemm", "popcount", "pallas", "fused")


def _random_docs(n_docs, vocab, seed, mean_len=5):
    rng = np.random.default_rng(seed)
    lens = np.clip(rng.poisson(mean_len, n_docs), 1, None)
    return [rng.integers(0, vocab, ln).tolist() for ln in lens]


def _same_index(t_idx, j_idx):
    np.testing.assert_array_equal(to_uint32(t_idx.packed),
                                  np.asarray(j_idx.packed))
    np.testing.assert_array_equal(t_idx.doc_freq.numpy(),
                                  np.asarray(j_idx.doc_freq))
    assert t_idx.n_docs == int(j_idx.n_docs)


def _same_network(t_net, j_net, what=""):
    for field in ("src", "dst", "weight", "valid"):
        np.testing.assert_array_equal(
            np.asarray(getattr(t_net, field)),
            np.asarray(getattr(j_net, field)), err_msg=f"{what}/{field}")


def _same_query(t_ctx, j_ctx, seed_term, method, *, depth=2, topk=4, beam=8,
                scope=None):
    kw = dict(seeds=(int(seed_term),), depth=depth, topk=topk, beam=beam,
              method=method, scope=scope)
    _same_network(T.construct(t_ctx, T.QuerySpec(**kw)).network,
                  J.construct(j_ctx, J.QuerySpec(**kw)).network, method)


def _same_context(t_ctx, j_ctx):
    """Index bits, ring state, scopes, cold tier and the public surface."""
    _same_index(t_ctx.index, j_ctx.index)
    for attr in ("window", "live_docs", "n_blocks", "n_docs", "vocab_size",
                 "epoch", "evicted_docs_total", "unpack_count", "_ring_tail",
                 "_stranded"):
        assert getattr(t_ctx, attr) == getattr(j_ctx, attr), attr
    assert t_ctx.index.capacity == j_ctx.index.capacity
    np.testing.assert_array_equal(t_ctx.live_slots(), j_ctx.live_slots())
    assert t_ctx.scope_names() == j_ctx.scope_names()
    for name in t_ctx.scope_names():
        np.testing.assert_array_equal(to_uint32(t_ctx.scope(name)),
                                      np.asarray(j_ctx.scope(name)))
        assert t_ctx.scope_version(name) == j_ctx.scope_version(name)
    assert t_ctx.cold_blocks() == j_ctx.cold_blocks()
    assert t_ctx.cold_version() == j_ctx.cold_version()
    if j_ctx.cold_store is not None:
        assert sorted(t_ctx.cold_store) == sorted(j_ctx.cold_store)
        for key in j_ctx.cold_store:
            a = T.decode_block(t_ctx.cold_store[key])
            b = j_decode(j_ctx.cold_store[key])
            np.testing.assert_array_equal(a.packed, b.packed, err_msg=key)
            np.testing.assert_array_equal(a.doc_freq, b.doc_freq)
            assert (a.n_docs, a.vocab) == (b.n_docs, b.vocab)


def _pair(docs, vocab, *, cold=False, **kw):
    """A port and a reference context over the same docs (each with its
    own empty cold store when ``cold``)."""
    return (T.QueryContext.from_docs(docs, vocab, device="cpu",
                                     cold_store={} if cold else None, **kw),
            J.QueryContext.from_docs(docs, vocab,
                                     cold_store={} if cold else None, **kw))


def _ingest_both(t_ctx, j_ctx, docs, **kw):
    a = t_ctx.ingest_docs(docs, **kw)
    b = j_ctx.ingest_docs(docs, **kw)
    np.testing.assert_array_equal(a, b)
    return a


# ---------------------------------------------------------------------------
# retire_docs / ingest_at / slots_bitmap
# ---------------------------------------------------------------------------


class TestRetireDocs:
    @pytest.mark.parametrize("gone", [[0, 3, 17, 41, 59],
                                      [31, 32, 63, 95, 30, 64],
                                      list(range(28, 70))])
    def test_retire_equals_reference_and_rebuild(self, gone):
        """Bit 31 of a word (a negative int32) and blocks straddling words
        are cleared and counted exactly; the input stays unmodified."""
        docs = _random_docs(96, 32, 0)
        t_idx = T.pack_docs(docs, 32, capacity=128, device="cpu")
        j_idx = J.pack_docs(docs, 32, capacity=128)
        before = t_idx.packed.clone()
        mask = J.slots_bitmap(gone, j_idx.n_words)
        t_out = T.retire_docs(t_idx, mask)
        _same_index(t_out, J.retire_docs(j_idx, jnp.asarray(mask)))
        assert torch.equal(t_idx.packed, before)
        keep = [d for i, d in enumerate(docs) if i not in set(gone)]
        np.testing.assert_array_equal(
            t_out.doc_freq.numpy(),
            T.pack_docs(keep, 32, device="cpu").doc_freq.numpy())
        packed = to_uint32(t_out.packed)
        for s in gone:
            assert not (packed[s // 32] >> np.uint32(s % 32) & 1).any()
        assert t_out.n_docs == 96

    def test_retire_takes_a_bit_pattern_tensor(self):
        idx = T.pack_docs(_random_docs(64, 8, 1), 8, device="cpu")
        mask = T.slots_bitmap([1, 31, 33], idx.n_words)
        a = T.retire_docs(idx, mask)
        b = T.retire_docs(idx, T.from_uint32(mask, "cpu"))
        assert torch.equal(a.packed, b.packed)
        assert torch.equal(a.doc_freq, b.doc_freq)

    def test_retire_empty_mask_is_identity(self):
        idx = T.pack_docs(_random_docs(20, 8, 2), 8, device="cpu")
        idx2 = T.retire_docs(idx, np.zeros((idx.n_words,), np.uint32))
        assert torch.equal(idx.packed, idx2.packed)
        assert torch.equal(idx.doc_freq, idx2.doc_freq)


class TestIngestAt:
    def test_ring_write_into_retired_slots(self):
        """Retire a slot range and write other docs into it: equals the
        reference and an index built with the final doc-per-slot layout."""
        docs = _random_docs(32, 16, 3)
        t_idx = T.pack_docs(docs, 16, capacity=64, device="cpu")
        j_idx = J.pack_docs(docs, 16, capacity=64)
        gone = np.arange(8)
        mask = J.slots_bitmap(gone, j_idx.n_words)
        t_idx = T.retire_docs(t_idx, mask)
        j_idx = J.retire_docs(j_idx, jnp.asarray(mask))
        fresh = _random_docs(8, 16, 4)
        ids = np.full((8, 16), -1, np.int32)
        for i, d in enumerate(fresh):
            ids[i, :len(d)] = d[:16]
        t_idx = T.ingest_at(t_idx, torch.from_numpy(ids),
                            torch.ones(8, dtype=torch.bool),
                            torch.from_numpy(gone))
        j_idx = J.ingest_at(j_idx, jnp.asarray(ids), jnp.ones(8, bool),
                            jnp.asarray(gone, jnp.int32))
        _same_index(t_idx, j_idx)
        ref = T.pack_docs(fresh + docs[8:], 16, capacity=64, device="cpu")
        assert torch.equal(t_idx.packed, ref.packed)
        assert torch.equal(t_idx.doc_freq, ref.doc_freq)

    def test_high_water_mark_never_shrinks(self):
        idx = T.pack_docs(_random_docs(10, 8, 5), 8, capacity=64,
                          device="cpu")
        ids = torch.tensor([[0, 1]], dtype=torch.int32)
        one = torch.ones(1, dtype=torch.bool)
        cleared = T.retire_docs(idx, T.slots_bitmap([3], idx.n_words))
        assert T.ingest_at(cleared, ids, one, torch.tensor([3])).n_docs == 10
        assert T.ingest_at(idx, ids, one, torch.tensor([41])).n_docs == 42

    def test_slots_bitmap_bounds(self):
        with pytest.raises(ValueError, match="out of range"):
            T.slots_bitmap([64], 2)
        np.testing.assert_array_equal(T.slots_bitmap([0, 33, 63], 2),
                                      J.slots_bitmap([0, 33, 63], 2))


# ---------------------------------------------------------------------------
# the window ring
# ---------------------------------------------------------------------------


class TestWindowRing:
    def test_capacity_pinned_and_live_bounded(self):
        t_ctx, j_ctx = _pair([], 16, window=50)
        assert t_ctx.index.capacity == 64
        for r in range(20):
            _ingest_both(t_ctx, j_ctx, _random_docs(10, 16, 100 + r),
                         max_len=16)
            assert t_ctx.index.capacity == 64 and t_ctx.live_docs <= 50
        _same_context(t_ctx, j_ctx)
        assert t_ctx.evicted_docs_total == 150

    @pytest.mark.parametrize("method", METHODS)
    def test_eviction_equivalence_warm_and_cold(self, method):
        """After evictions, queries through a warm cache (built before
        the first eviction) and a cold one equal the reference's and a
        rebuild on the surviving docs, slot for slot."""
        blocks = [_random_docs(12, 24, 200 + r) for r in range(6)]
        t_ctx, j_ctx = _pair([], 24, window=30)
        _ingest_both(t_ctx, j_ctx, blocks[0], max_len=16)
        spec = dict(seeds=(1,), depth=1, topk=2, beam=4, method=method)
        T.construct(t_ctx, T.QuerySpec(**spec))
        J.construct(j_ctx, J.QuerySpec(**spec))
        warm = t_ctx.unpack_count
        for blk in blocks[1:]:
            _ingest_both(t_ctx, j_ctx, blk, max_len=16)
        surviving = [d for blk in blocks[-2:] for d in blk]
        cold = T.QueryContext.from_docs(surviving, 24,
                                        capacity=t_ctx.index.capacity,
                                        device="cpu")
        assert torch.equal(t_ctx.index.doc_freq, cold.index.doc_freq)
        seed = int(torch.argmax(cold.index.doc_freq))
        _same_query(t_ctx, j_ctx, seed, method)
        kw = dict(seeds=(seed,), depth=2, topk=4, beam=8, method=method)
        want = T.construct(cold, T.QuerySpec(**kw)).network
        _same_network(T.construct(t_ctx, T.QuerySpec(**kw)).network, want)
        if method == "gemm":
            assert t_ctx.unpack_count == warm + 1
        bare = T.QueryContext(t_ctx.index, device="cpu")
        _same_network(T.construct(bare, T.QuerySpec(**kw)).network, want)
        _same_context(t_ctx, j_ctx)

    def test_ring_wraps_and_reuses_slots(self):
        t_ctx, j_ctx = _pair([], 8, window=33)       # capacity 64 > window
        for r in range(12):
            _ingest_both(t_ctx, j_ctx, [[r % 8]] * 10, max_len=2)
        live = t_ctx.live_slots()
        assert len(np.unique(live)) == len(live) == t_ctx.live_docs <= 33
        assert int(t_ctx.index.doc_freq.sum()) == t_ctx.live_docs
        _same_context(t_ctx, j_ctx)

    def test_block_larger_than_window_rejected(self):
        ctx = T.QueryContext.from_docs([], 8, window=16, device="cpu")
        epoch = ctx.epoch
        with pytest.raises(ValueError, match="exceeds window"):
            ctx.ingest_docs([[0]] * 17, max_len=2)
        assert ctx.epoch == epoch and ctx.live_docs == 0

    def test_initial_corpus_larger_than_window_rejected(self):
        docs = [[0, 1]] * 100
        with pytest.raises(ValueError, match="exceeds window"):
            T.QueryContext.from_docs(docs, 8, window=50, device="cpu")
        t_ctx, j_ctx = _pair(docs, 8, window=100)
        assert t_ctx.live_docs == 100
        _same_context(t_ctx, j_ctx)

    def test_window_via_ingest_docs_kwarg(self):
        t_ctx, j_ctx = _pair(_random_docs(20, 8, 6), 8, capacity=64)
        assert t_ctx.window is None
        _ingest_both(t_ctx, j_ctx, _random_docs(10, 8, 7), max_len=16,
                     window=24)
        assert t_ctx.window == 24 and t_ctx.live_docs <= 24
        _same_context(t_ctx, j_ctx)

    def test_shrinking_window_evicts_immediately(self):
        t_ctx, j_ctx = _pair([], 8, window=40)
        for r in range(4):
            _ingest_both(t_ctx, j_ctx, [[r % 8]] * 10, max_len=2)
        assert t_ctx.live_docs == 40
        for ctx in (t_ctx, j_ctx):
            ctx.set_window(15)
        assert t_ctx.live_docs == 10             # whole-block granularity
        _same_context(t_ctx, j_ctx)
        with pytest.raises(ValueError, match="window must be"):
            t_ctx.set_window(0)

    def test_window_growth_after_wrap_never_collides(self):
        """Growing the window after the ring wrapped strands live blocks
        in the padded ring; the next ingest evicts those its target slots
        overlap instead of scattering into occupied slots."""
        t_ctx, j_ctx = _pair([], 8, window=33)
        slot2doc = {}
        for r in range(8):                     # wraps the 64-slot ring
            blk = [[r % 8, (r + 1) % 8]] * 10
            for s, d in zip(_ingest_both(t_ctx, j_ctx, blk, max_len=4), blk):
                slot2doc[int(s)] = d
        for ctx in (t_ctx, j_ctx):
            ctx.set_window(100)                # pads capacity 64 -> 128
        assert t_ctx._stranded == j_ctx._stranded > 0
        blk = [[3, 5]] * 70
        for s, d in zip(_ingest_both(t_ctx, j_ctx, blk, max_len=4), blk):
            slot2doc[int(s)] = d
        _same_context(t_ctx, j_ctx)
        live = t_ctx.live_slots()
        assert len(np.unique(live)) == len(live)
        ref = T.QueryContext.from_docs([slot2doc[s] for s in live.tolist()],
                                       8, capacity=t_ctx.index.capacity,
                                       device="cpu")
        assert torch.equal(t_ctx.index.doc_freq, ref.index.doc_freq)
        for method in METHODS:
            _same_query(t_ctx, j_ctx, 3, method, depth=1)

    def test_set_window_shrink_invalidates_warm_gemm_cache(self):
        docs = _random_docs(40, 16, 8)
        t_ctx, j_ctx = _pair([], 16, window=40)
        for i in range(4):
            _ingest_both(t_ctx, j_ctx, docs[i * 10:(i + 1) * 10], max_len=16)
        spec = T.QuerySpec(seeds=(1,), depth=1, topk=4, beam=4)
        T.construct(t_ctx, spec)               # warm x_dense
        for ctx in (t_ctx, j_ctx):
            ctx.set_window(15)                 # evicts 3 blocks
        want = T.construct(T.QueryContext.from_docs(docs[30:], 16,
                                                    device="cpu"),
                           spec).edges()
        assert T.construct(t_ctx, spec).edges() == want
        _same_query(t_ctx, j_ctx, 1, "gemm", depth=1, beam=4)

    def test_retire_oldest_block_manual(self):
        t_ctx, j_ctx = _pair([], 8, capacity=64)
        _ingest_both(t_ctx, j_ctx, [[0, 1]] * 5, max_len=4)
        _ingest_both(t_ctx, j_ctx, [[2, 3]] * 4, max_len=4)
        epoch = t_ctx.epoch
        assert t_ctx.retire_oldest_block() == j_ctx.retire_oldest_block() == 5
        assert t_ctx.epoch == epoch + 1 and t_ctx.live_docs == 4
        np.testing.assert_array_equal(t_ctx.index.doc_freq.numpy(),
                                      [0, 0, 4, 4, 0, 0, 0, 0])
        assert t_ctx.retire_oldest_block() == j_ctx.retire_oldest_block() == 4
        assert t_ctx.retire_oldest_block() == 0  # empty: no epoch bump
        j_ctx.retire_oldest_block()
        _same_context(t_ctx, j_ctx)


class TestScopes:
    def test_eviction_clears_scope_bits(self):
        t_ctx, j_ctx = _pair([], 8, window=10)
        _ingest_both(t_ctx, j_ctx, [[0, 1]] * 6, max_len=4, scope="tagged")
        t_ctx.scope("tagged")                  # a device copy to drop
        _ingest_both(t_ctx, j_ctx, [[2, 3]] * 6, max_len=4, scope="tagged")
        spec = dict(seeds=(2,), depth=1, topk=4, beam=4, scope="tagged",
                    method="popcount")
        assert T.construct(t_ctx, T.QuerySpec(**spec)).edges() == {
            (2, 3): 6}
        live = T.slots_bitmap(t_ctx.live_slots(), t_ctx.index.n_words)
        assert (to_uint32(t_ctx.scope("tagged")) & ~live).sum() == 0
        _same_context(t_ctx, j_ctx)
        for method in METHODS:
            _same_query(t_ctx, j_ctx, 2, method, depth=1, scope="tagged")


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------


class TestFacadeStreaming:
    TEXTS = [(["alpha beta gamma"] * 3, 100.0, "wire"),
             (["alpha beta delta"] * 3, 200.0, None),
             (["alpha epsilon beta"] * 3, 300.0, "wire")]

    def _streamed(self):
        kw = dict(window=8, depth=1, topk=8, beam=8)
        t_idx, j_idx = TIndex(device="cpu", **kw), JIndex(**kw)
        for texts, ts, source in self.TEXTS:
            for idx in (t_idx, j_idx):
                idx.add_documents(texts, timestamp=ts, source=source)
        return t_idx, j_idx

    def test_window_bounds_live_docs_and_capacity(self):
        t_idx, j_idx = self._streamed()
        assert t_idx.window == j_idx.window == 8
        assert t_idx.live_docs == j_idx.live_docs == 6
        assert t_idx.n_docs == j_idx.n_docs
        assert t_idx.ctx.index.capacity == 32
        full = t_idx.network(["alpha"])
        assert full == j_idx.network(["alpha"])
        assert full[("alpha", "beta")] == 6 and ("alpha", "gamma") not in full
        _same_context(t_idx.ctx, j_idx.ctx)

    def test_time_bucket_and_source_tag_scopes(self):
        t_idx, j_idx = self._streamed()
        for kw in (dict(scope="2m", now=330.0), dict(scope="2m", now=320.0),
                   dict(scope="wire")):
            assert t_idx.network(["alpha"], **kw) == j_idx.network(["alpha"],
                                                                   **kw)
        assert t_idx.network(["alpha"], scope="wire") == {
            ("alpha", "epsilon"): 3, ("alpha", "beta"): 3}
        with pytest.raises(KeyError, match="unknown scope"):
            t_idx.network(["alpha"], scope="nope")

    def test_reused_ring_slots_take_new_timestamps(self):
        """The first batch's slots are reused by a later batch; a time
        bucket then sees the new batch's time in those slots."""
        t_idx, j_idx = self._streamed()
        for idx in (t_idx, j_idx):
            idx.add_documents(["zeta eta"] * 3, timestamp=400.0)
        slots = t_idx.ctx._blocks[-1]
        np.testing.assert_array_equal(t_idx._doc_time[slots], 400.0)
        np.testing.assert_array_equal(t_idx._doc_time, j_idx._doc_time)
        kw = dict(scope="90s", now=400.0)
        assert t_idx.network(["zeta"], **kw) == j_idx.network(["zeta"], **kw)
        assert t_idx.network(["zeta"], **kw) == {("zeta", "eta"): 3}

    def test_time_bucket_reuse_keeps_device_cache_warm(self):
        t_idx, _ = self._streamed()
        t_idx.network(["alpha"], scope="2m", now=330.0)
        ent1 = t_idx.ctx._scope_dev.get("2m")
        t_idx.network(["alpha"], scope="2m", now=331.0)
        assert ent1 is not None and t_idx.ctx._scope_dev.get("2m") is ent1

    def test_capacity_with_window_is_contradictory(self):
        with pytest.raises(ValueError, match="contradictory"):
            TIndex(device="cpu", capacity=100_000, window=1000)
        assert TIndex(device="cpu", capacity=64).ctx.index.capacity == 64
        assert TIndex(device="cpu", window=1000).ctx.index.capacity == 1024

    def test_engine_ingest_doc_window_kwarg(self):
        t_ctx, j_ctx = _pair([], 8, capacity=64)
        kw = dict(depth=1, topk=2, beam=4, q_batch=1, window=16)
        t_eng, j_eng = TEngine(t_ctx, device="cpu", **kw), JEngine(j_ctx,
                                                                     **kw)
        for eng in (t_eng, j_eng):
            eng.ingest_docs([[0, 1]] * 10, max_len=4, doc_window=12)
        assert t_ctx.window == 12 and t_eng.window == 16
        for eng in (t_eng, j_eng):
            eng.ingest_docs([[2, 3]] * 10, max_len=4)
        assert t_ctx.live_docs <= 12
        _same_context(t_ctx, j_ctx)
        assert t_eng.query([2]) == j_eng.query([2])

    def test_oversize_batch_rejected_before_lexicon_mutation(self):
        idx = TIndex(device="cpu", window=4, depth=1, topk=4, beam=4)
        with pytest.raises(ValueError, match="exceeds window"):
            idx.add_documents(["zyzzyva quokka"] * 5)
        assert "zyzzyva" not in idx
        assert idx.n_terms == 0 and idx.n_docs == 0 and idx.ctx.epoch == 0

    def test_unwindowed_facade_unchanged(self):
        idx = TIndex.from_texts(["alpha beta", "alpha gamma"], device="cpu",
                                depth=1, topk=4, beam=4)
        assert idx.window is None
        assert idx.live_docs == idx.n_docs == 2
        assert idx.network(["alpha"]) == {("alpha", "beta"): 1,
                                          ("alpha", "gamma"): 1}


# ---------------------------------------------------------------------------
# lockstep state machine: reference and port under the same random steps
# ---------------------------------------------------------------------------


class TestRingStateMachine:
    """Random interleavings of ingest, set_window (grow across word
    boundaries, and shrink), retire_oldest_block and tag_scope run on a
    reference and a port context with cold stores; after every step the
    two must agree on the bits, ``doc_freq``, the ring state, the scopes,
    the cold payloads, the public attributes, the MinHash signatures and
    one query per method.  At one random step the port context is saved
    and replaced by its restored copy, which must track on."""

    @pytest.mark.parametrize("seed", range(6))
    def test_random_interleavings_track_reference(self, seed, tmp_path):
        rng = np.random.default_rng(1000 + seed)
        vocab = int(rng.integers(4, 17))
        w0 = int(rng.integers(8, 41))
        t_ctx, j_ctx = _pair([], vocab, window=w0, cold=True)
        _same_context(t_ctx, j_ctx)
        restore_at = int(rng.integers(0, 8))
        for step in range(8):
            op = int(rng.integers(0, 6))
            if op <= 1 or not j_ctx.n_blocks:
                n = int(rng.integers(1, min(j_ctx.window, 6) + 1))
                docs = [rng.integers(0, vocab, int(rng.integers(1, 5)))
                        .tolist() for _ in range(n)]
                scope = [None, "a", "b"][int(rng.integers(0, 3))]
                _ingest_both(t_ctx, j_ctx, docs, max_len=8, scope=scope)
            elif op == 2:
                assert (t_ctx.retire_oldest_block()
                        == j_ctx.retire_oldest_block())
            elif op in (3, 4):
                w = (j_ctx.window + int(rng.integers(1, 65)) if op == 3
                     else max(1, j_ctx.window - int(rng.integers(1, 21))))
                for ctx in (t_ctx, j_ctx):
                    ctx.set_window(w)
            else:
                live = j_ctx.live_slots()
                pick = sorted(rng.choice(live, int(rng.integers(
                    1, len(live) + 1)), replace=False).tolist())
                for ctx in (t_ctx, j_ctx):
                    ctx.tag_scope("c", pick)
            if step == restore_at:
                T.save_context(t_ctx, str(tmp_path / "snap"))
                t_ctx = T.load_context(str(tmp_path / "snap"), device="cpu",
                                       cold_store={})
            _same_context(t_ctx, j_ctx)
            np.testing.assert_array_equal(
                to_uint32(t_ctx.term_signatures(num_perm=16)),
                np.asarray(j_ctx.term_signatures(num_perm=16)))
            seed_t = int(np.argmax(np.asarray(j_ctx.index.doc_freq)))
            for method in METHODS:
                _same_query(t_ctx, j_ctx, seed_t, method)
