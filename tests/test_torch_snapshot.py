"""The port's snapshots against the JAX reference, in both directions.

The port's ``repro_torch.core.snapshot`` writes the reference's format
byte for byte.  Mirrored from ``tests/test_snapshot.py``: the context and
``CoocIndex`` round trips (bit-exact answers, a restored ring that keeps
streaming, derived caches not serialized, checksums, versions, ``keep=``),
the crash injection of the commit protocol and the cold tier carried by a
snapshot.  Across packages: a reference ``CoocIndex.save`` loaded by the
port and a port save loaded by the reference answer every method's
queries, exact and approx ``full_network`` and ``network_stats``
identically; the same state gives the same per-blob sha256 and the same
meta apart from ``created_unix``; a restore rehashes no sketched block.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402,F401

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.api import CoocIndex as JIndex  # noqa: E402
from repro.core import snapshot as j_snapshot  # noqa: E402
from repro_torch.api import CoocIndex as TIndex  # noqa: E402
from repro_torch.core import atomic_io, sketch as TS  # noqa: E402
from repro_torch.core.inverted_index import to_uint32  # noqa: E402

METHODS = ("gemm", "popcount", "pallas", "fused")
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

CORPUS = [
    "graph neural networks learn node embeddings from graph structure",
    "co-occurrence networks reveal semantic relationships in text corpora",
    "inverted index maps keywords to documents for fast retrieval",
    "keyword co-occurrence networks support text mining and retrieval",
    "the inverted index makes co-occurrence network construction fast",
    "fast retrieval of documents uses the inverted index keywords",
    "text mining extracts keywords and builds co-occurrence networks",
]
DOCS = [[0, 1, 2], [1, 2, 3], [2, 3, 4], [0, 4, 5], [5, 6], [0, 6, 7],
        [7, 8, 9], [1, 8], [3, 9, 10], [2, 10, 11]]
VOCAB = 12
T0 = 1_700_000_000.0


def _net_identical(a, b, msg=""):
    for f in ("src", "dst", "weight", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"{msg}/{f}")


def _ctx(docs=(), **kw):
    return T.QueryContext.from_docs(list(docs), VOCAB, device="cpu", **kw)


def _assert_ctx_equivalent(a, b, *, scopes=(None,), msg=""):
    """Every query and exact network identical on two port contexts."""
    for method in METHODS:
        for scope in scopes:
            spec = T.QuerySpec(seeds=(0, 2), depth=2, topk=4, beam=8,
                               method=method, scope=scope)
            _net_identical(T.construct(a, spec).network,
                           T.construct(b, spec).network,
                           f"{msg}/construct/{method}/{scope}")
            _net_identical(T.materialize(a, k=4, method=method, scope=scope),
                           T.materialize(b, k=4, method=method, scope=scope),
                           f"{msg}/materialize/{method}/{scope}")


def _manifest(final):
    with open(os.path.join(final, "manifest.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the port's own round trips (tests/test_snapshot.py, TestContextRoundTrip)
# ---------------------------------------------------------------------------


class TestContextRoundTrip:
    def test_plain_context_bit_exact(self, tmp_path):
        ctx = _ctx(DOCS)
        T.save_context(ctx, str(tmp_path / "snap"))
        ctx2 = T.load_context(str(tmp_path / "snap"), device="cpu")
        assert (ctx2.n_docs, ctx2.epoch) == (ctx.n_docs, ctx.epoch)
        _assert_ctx_equivalent(ctx, ctx2, msg="plain")

    def test_windowed_scoped_context_bit_exact(self, tmp_path):
        ctx = _ctx(capacity=32, window=6)
        ctx.ingest_docs(DOCS[:4], scope="early")
        ctx.ingest_docs(DOCS[4:8], scope="mid")
        ctx.ingest_docs(DOCS[8:], scope="late")   # evicts the oldest block
        assert ctx.evicted_docs_total > 0
        T.save_context(ctx, str(tmp_path / "snap"))
        ctx2 = T.load_context(str(tmp_path / "snap"), device="cpu")
        for attr in ("window", "live_docs", "evicted_docs_total",
                     "_ring_tail", "_stranded", "_scope_ver"):
            assert getattr(ctx2, attr) == getattr(ctx, attr), attr
        assert ctx2.scope_names() == ctx.scope_names()
        np.testing.assert_array_equal(ctx2.live_slots(), ctx.live_slots())
        _assert_ctx_equivalent(ctx, ctx2, scopes=(None, "mid", "late"),
                               msg="windowed")

    def test_restored_context_keeps_streaming(self, tmp_path):
        ctx = _ctx(capacity=32, window=6)
        ctx.ingest_docs(DOCS[:4], scope="a")
        ctx.ingest_docs(DOCS[4:6], scope="b")
        T.save_context(ctx, str(tmp_path / "snap"))
        ctx2 = T.load_context(str(tmp_path / "snap"), device="cpu")
        more = [[1, 5, 9], [0, 3, 11], [2, 7]]
        np.testing.assert_array_equal(ctx.ingest_docs(more, scope="c"),
                                      ctx2.ingest_docs(more, scope="c"))
        assert ctx2.evicted_docs_total == ctx.evicted_docs_total > 0
        _assert_ctx_equivalent(ctx, ctx2, scopes=(None, "b", "c"),
                               msg="resumed")

    def test_derived_caches_not_serialized(self, tmp_path):
        ctx = _ctx(DOCS)
        T.materialize(ctx, k=4)                   # warms x_dense
        T.save_context(ctx, str(tmp_path / "snap"))
        arrays, meta = T.read_snapshot(str(tmp_path / "snap"))
        assert set(arrays) == {"packed", "doc_freq"} | {
            f"block_{i:04d}" for i in range(meta["n_blocks"])}
        ctx2 = T.load_context(str(tmp_path / "snap"), device="cpu")
        assert ctx2.unpack_count == ctx.unpack_count == 1
        _net_identical(T.materialize(ctx, k=4), T.materialize(ctx2, k=4))

    def test_mmapable_blobs(self, tmp_path):
        final = T.save_context(_ctx(DOCS), str(tmp_path / "snap"))
        blob = _manifest(final)["blobs"]["packed"]
        arr = np.load(os.path.join(final, blob["file"]), mmap_mode="r")
        assert arr.dtype == np.uint32
        np.testing.assert_array_equal(arr, to_uint32(_ctx(DOCS).index.packed))

    def test_corrupt_blob_raises(self, tmp_path):
        final = T.save_context(_ctx(DOCS), str(tmp_path / "snap"))
        victim = os.path.join(final,
                              _manifest(final)["blobs"]["packed"]["file"])
        data = bytearray(open(victim, "rb").read())
        data[-1] ^= 0xFF
        with open(victim, "wb") as f:
            f.write(bytes(data))
        with pytest.raises(T.SnapshotError, match="checksum"):
            T.load_context(str(tmp_path / "snap"), device="cpu")
        T.load_context(str(tmp_path / "snap"), device="cpu", verify=False)

    def test_missing_and_future_snapshots(self, tmp_path):
        with pytest.raises(T.SnapshotError, match="no snapshot"):
            T.load_context(str(tmp_path / "nope"), device="cpu")
        final = T.save_context(_ctx(DOCS), str(tmp_path / "snap"))
        man = _manifest(final)
        man["version"] = 999
        with open(os.path.join(final, "manifest.json"), "w") as f:
            json.dump(man, f)
        with pytest.raises(T.SnapshotError, match="newer"):
            T.load_context(str(tmp_path / "snap"), device="cpu")

    def test_keep_gc(self, tmp_path):
        ctx = _ctx(DOCS)
        for _ in range(4):
            T.save_context(ctx, str(tmp_path / "snap"), keep=2)
        assert len([d for d in os.listdir(tmp_path / "snap")
                    if d.startswith("snap-")]) == 2
        T.load_context(str(tmp_path / "snap"), device="cpu")

    def test_restore_needs_a_card_unless_told_cpu(self, tmp_path,
                                                  monkeypatch):
        T.save_context(_ctx(DOCS), str(tmp_path / "snap"))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError):
            T.load_context(str(tmp_path / "snap"))
        with pytest.raises(TypeError, match="CoocMesh"):
            T.load_context(str(tmp_path / "snap"), device="cpu",
                           mesh=object())


def test_snapshot_carries_cold_tier(tmp_path):
    cold = {}
    ctx = _ctx(capacity=64, window=4, cold_store=cold)
    for lo in range(0, len(DOCS), 2):
        ctx.ingest_docs(DOCS[lo:lo + 2])
    assert ctx.cold_blocks() > 0
    T.save_context(ctx, str(tmp_path / "snap"))
    ctx2 = T.load_context(str(tmp_path / "snap"), device="cpu")
    assert ctx2.cold_blocks() == ctx.cold_blocks()
    assert ctx2.cold_version() == ctx.cold_version()
    assert sorted(ctx2.cold_store) == sorted(cold)
    for method in ("gemm", "popcount"):
        _net_identical(
            T.materialize(ctx2, k=4, method=method, scope="all-time"),
            T.materialize(ctx, k=4, method=method, scope="all-time"), method)
    ctx.ingest_docs(DOCS[:2])
    ctx2.ingest_docs(DOCS[:2])
    assert ctx2.cold_version() == ctx.cold_version()
    _net_identical(T.materialize(ctx2, k=4, scope="all-time"),
                   T.materialize(ctx, k=4, scope="all-time"), "post-spill")


def test_restore_rehashes_no_sketched_block(tmp_path, monkeypatch):
    """The signatures ride in the snapshot: with ``block_signatures``
    poisoned, the restored context serves the same signature and the same
    approx network; only a block ingested after the restore is hashed."""
    ctx = _ctx(capacity=64, window=40)
    rng = np.random.default_rng(0)
    for _ in range(3):
        ctx.ingest_docs([rng.integers(0, VOCAB, 4).tolist()
                         for _ in range(9)])
    net = T.materialize(ctx, k=4, mode="approx", num_perm=32,
                        method="popcount")
    sig = to_uint32(ctx.term_signatures(num_perm=32))
    T.save_context(ctx, str(tmp_path / "snap"))
    ctx2 = T.load_context(str(tmp_path / "snap"), device="cpu")
    assert ctx2._sketch_blocks

    def poisoned(*a, **k):
        raise AssertionError("restore must not rehash live blocks")

    monkeypatch.setattr(TS, "block_signatures", poisoned)
    np.testing.assert_array_equal(
        to_uint32(ctx2.term_signatures(num_perm=32)), sig)
    _net_identical(net, T.materialize(ctx2, k=4, mode="approx",
                                      num_perm=32, method="popcount"))
    monkeypatch.undo()
    ctx.ingest_docs([[1, 2, 3]])
    ctx2.ingest_docs([[1, 2, 3]])
    np.testing.assert_array_equal(
        to_uint32(ctx2.term_signatures(num_perm=32)),
        to_uint32(ctx.term_signatures(num_perm=32)))


# ---------------------------------------------------------------------------
# CoocIndex round trips (tests/test_snapshot.py, TestCoocIndexRoundTrip)
# ---------------------------------------------------------------------------


def _build(cls, **kw):
    idx = cls(window=6, depth=2, topk=4, beam=8, q_batch=2, **kw)
    idx.add_documents(CORPUS[:3], timestamp=T0 - 10 * 86400,
                      source="old-news")
    idx.add_documents(CORPUS[3:5], timestamp=T0 - 3600, source="news")
    idx.add_documents(CORPUS[5:], timestamp=T0 - 60, source="fresh")
    return idx


class TestCoocIndexRoundTrip:
    def test_save_load_bit_exact_all_methods(self, tmp_path):
        idx = _build(TIndex, device="cpu")
        idx.network(["index"], scope="7d", now=T0)   # a live time bucket
        idx.save(str(tmp_path / "snap"))
        idx2 = TIndex.load(str(tmp_path / "snap"), device="cpu")
        assert (idx2.n_terms, idx2.live_docs, idx2.window) == (
            idx.n_terms, idx.live_docs, idx.window)
        assert idx2._bucket_state == idx._bucket_state
        np.testing.assert_array_equal(idx2._doc_time, idx._doc_time)
        for method in METHODS:
            assert (idx2.network(["index"], method=method)
                    == idx.network(["index"], method=method))
            assert (idx2.full_network(k=4, method=method)
                    == idx.full_network(k=4, method=method))
        for scope in ("news", "fresh", "7d"):
            assert (idx2.network(["index"], scope=scope, now=T0)
                    == idx.network(["index"], scope=scope, now=T0))
            assert (idx2.full_network(k=4, scope=scope, now=T0)
                    == idx.full_network(k=4, scope=scope, now=T0))

    def test_post_load_ingest_parity(self, tmp_path):
        idx = _build(TIndex, device="cpu")
        idx.save(str(tmp_path / "snap"))
        idx2 = TIndex.load(str(tmp_path / "snap"), device="cpu")
        fresh = ["co-occurrence mining finds keyword structure",
                 "new documents keep the index real time"]
        idx.add_documents(fresh, timestamp=T0, source="newest")
        idx2.add_documents(fresh, timestamp=T0, source="newest")
        assert idx2.n_terms == idx.n_terms
        assert idx2.network(["index"]) == idx.network(["index"])
        assert (idx2.full_network(k=4, scope="newest")
                == idx.full_network(k=4, scope="newest"))
        assert (idx2.network(["index"], scope="1d", now=T0)
                == idx.network(["index"], scope="1d", now=T0))

    def test_engine_defaults_restored(self, tmp_path):
        idx = TIndex.from_texts(CORPUS, device="cpu", depth=1, topk=3,
                                beam=5, q_batch=4, method="popcount",
                                on_overflow="grow")
        idx.save(str(tmp_path / "snap"))
        idx2 = TIndex.load(str(tmp_path / "snap"), device="cpu")
        for f in ("depth", "topk", "beam", "dedup", "method", "q_batch",
                  "on_overflow", "window"):
            assert getattr(idx2.engine, f) == getattr(idx.engine, f), f
        assert sorted(idx2.stopwords) == sorted(idx.stopwords)
        assert idx2.lexicon.id_to_term == idx.lexicon.id_to_term

    def test_bare_context_snapshot_rejected(self, tmp_path):
        T.save_context(_ctx(DOCS), str(tmp_path / "snap"))
        with pytest.raises(T.SnapshotError, match="bare context"):
            TIndex.load(str(tmp_path / "snap"), device="cpu")

    def test_load_refuses_what_is_not_ported_and_needs_a_card(
            self, tmp_path, monkeypatch):
        _build(TIndex, device="cpu").save(str(tmp_path / "snap"))
        with pytest.raises(TypeError, match="CoocMesh"):
            TIndex.load(str(tmp_path / "snap"), device="cpu", mesh=object())
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError):
            TIndex.load(str(tmp_path / "snap"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TIndex.load(str(tmp_path / "snap"), device="cpu", devices=4)

    def test_fresh_process_round_trip(self, tmp_path):
        """A separate interpreter loads the snapshot and reproduces the
        saved process's whole network."""
        idx = _build(TIndex, device="cpu")
        idx.save(str(tmp_path / "snap"))
        want = sorted((a, b, w) for (a, b), w
                      in idx.full_network(k=4).items())
        code = ("from repro_torch.api import CoocIndex\n"
                f"idx = CoocIndex.load({str(tmp_path / 'snap')!r}, "
                "device='cpu')\n"
                "for (a, b), w in sorted(idx.full_network(k=4).items()):\n"
                "    print(a, b, w)\n")
        env = dict(os.environ, PYTHONPATH=SRC)
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        got = [tuple(line.split()) for line in out.stdout.splitlines()]
        assert sorted((a, b, int(w)) for a, b, w in got) == sorted(want)


# ---------------------------------------------------------------------------
# crash injection of the commit protocol (tests/test_snapshot.py)
# ---------------------------------------------------------------------------


class _Crash(BaseException):
    """Simulated kill -9 (a BaseException: no handler swallows it)."""


class _CrashAt:
    """Counts the commit protocol's low-level steps, raising instead of
    executing step number ``crash_at``."""

    NAMES = ("fsync_file", "fsync_path", "rename", "replace")

    def __init__(self, monkeypatch, crash_at=None):
        self.n = 0
        self.crash_at = crash_at
        for name in self.NAMES:
            orig = getattr(atomic_io, name)

            def wrapped(*a, _orig=orig, **kw):
                if self.crash_at is not None and self.n == self.crash_at:
                    raise _Crash(f"killed before op {self.n}")
                self.n += 1
                return _orig(*a, **kw)

            monkeypatch.setattr(atomic_io, name, wrapped)


def _count_ops(fn):
    mp = pytest.MonkeyPatch()
    try:
        counter = _CrashAt(mp)
        fn()
    finally:
        mp.undo()
    return counter.n


def _crashed_at(k, fn):
    mp = pytest.MonkeyPatch()
    try:
        counter = _CrashAt(mp, crash_at=k)
        with pytest.raises(_Crash):
            fn()
    finally:
        mp.undo()
    assert counter.n == k


class TestCrashInjection:
    def test_snapshot_survives_crash_at_every_step(self, tmp_path):
        ctx_a, ctx_b = _ctx(DOCS[:5]), _ctx(DOCS)
        packed_a = to_uint32(ctx_a.index.packed)
        packed_b = to_uint32(ctx_b.index.packed)
        probe = str(tmp_path / "probe")
        T.save_context(ctx_a, probe)
        total = _count_ops(lambda: T.save_context(ctx_b, probe))
        assert total >= 6          # fsyncs + rename + pointer swing
        outcomes = set()
        for k in range(total):
            d = str(tmp_path / f"crash-{k}")
            T.save_context(ctx_a, d)
            _crashed_at(k, lambda d=d: T.save_context(ctx_b, d))
            got = T.read_snapshot(d)[0]["packed"]
            if (got == packed_b).all():
                outcomes.add("new")
            else:
                np.testing.assert_array_equal(got, packed_a)
                outcomes.add("old")
            T.load_context(d, device="cpu")
        assert outcomes == {"old", "new"}

    def test_first_snapshot_crash_leaves_nothing_or_new(self, tmp_path):
        ctx = _ctx(DOCS)
        total = _count_ops(lambda: T.save_context(ctx,
                                                  str(tmp_path / "probe")))
        for k in range(total):
            d = str(tmp_path / f"crash-{k}")
            _crashed_at(k, lambda d=d: T.save_context(ctx, d))
            try:
                ctx2 = T.load_context(d, device="cpu")
            except T.SnapshotError:
                continue           # nothing committed yet
            assert ctx2.n_docs == ctx.n_docs

    def test_atomic_write_crash_leaves_old_file(self, tmp_path):
        path = str(tmp_path / "f.json")
        atomic_io.atomic_write_text(path, "OLD")
        total = _count_ops(lambda: atomic_io.atomic_write_text(path, "NEW"))
        for k in range(total):
            atomic_io.atomic_write_text(path, "OLD")
            _crashed_at(k, lambda: atomic_io.atomic_write_text(path, "NEW"))
            assert open(path).read() in ("OLD", "NEW")


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------


def _stream_pair():
    """The same windowed, scoped, spilling state with sketches in both
    packages (their sketch caches warmed the same way)."""
    rng = np.random.default_rng(3)
    docs = [rng.integers(0, VOCAB, int(rng.integers(1, 6))).tolist()
            for _ in range(60)]
    t_ctx = _ctx(window=25, cold_store={})
    j_ctx = J.QueryContext.from_docs([], VOCAB, window=25, cold_store={})
    for i, lo in enumerate(range(0, 60, 12)):
        for ctx in (t_ctx, j_ctx):
            ctx.ingest_docs(docs[lo:lo + 12], scope="odd" if i % 2 else None)
            ctx.term_signatures(num_perm=16)
            if i == 3:
                ctx.term_signatures(num_perm=8, seed=3)
    for ctx in (t_ctx, j_ctx):
        ctx.x_dense()                  # unpack_count rides in the meta
        ctx.grow_vocab(VOCAB + 3)      # the 8-perm sketches keep old V
    assert t_ctx.cold_blocks() > 0 and t_ctx.n_blocks == 2
    return t_ctx, j_ctx


def test_same_state_same_blobs_and_meta(tmp_path):
    t_ctx, j_ctx = _stream_pair()
    t_final = T.save_context(t_ctx, str(tmp_path / "port"))
    j_final = J.save_context(j_ctx, str(tmp_path / "ref"))
    t_man, j_man = _manifest(t_final), _manifest(j_final)
    assert t_man["blobs"] == j_man["blobs"]
    assert any(name.startswith("sketch_01_") for name in t_man["blobs"])
    for d in (t_man, j_man):
        del d["created_unix"]
    assert t_man == j_man
    for blob in t_man["blobs"].values():
        with open(os.path.join(t_final, blob["file"]), "rb") as f:
            t_bytes = f.read()
        with open(os.path.join(j_final, blob["file"]), "rb") as f:
            assert t_bytes == f.read(), blob["file"]


def test_unpack_count_is_restored_like_the_reference():
    """The port's restore reads ``unpack_count`` from the meta, as the
    reference's does."""
    j_ctx = J.QueryContext.from_docs(DOCS, VOCAB)
    j_ctx.x_dense()
    arrays, meta = j_snapshot.context_state(j_ctx)
    assert meta["unpack_count"] == 1
    t_ctx = T.context_from_state(arrays, meta, device="cpu")
    assert (t_ctx.unpack_count
            == j_snapshot.context_from_state(arrays, meta).unpack_count
            == 1)
    assert T.QueryContext is type(t_ctx)


def _answers(idx, pkg):
    """Every method's query and exact network, the approx network and
    the statistics, as comparable host values."""
    out = {}
    for method in METHODS:
        out[f"q/{method}"] = idx.network(["index"], method=method)
        out[f"full/{method}"] = idx.full_network(k=4, method=method)
        out[f"approx/{method}"] = idx.full_network(
            k=4, method=method, mode="approx", num_perm=16)
    out["all-time"] = idx.full_network(k=4, scope="all-time")
    out["approx/all-time"] = idx.full_network(k=4, scope="all-time",
                                              mode="approx", num_perm=16)
    for mode in ("exact", "approx"):
        stats = idx.network_stats(k=4, mode=mode, num_perm=16)
        out[f"stats/{mode}"] = [np.asarray(x).tolist() for x in stats]
    return out


@pytest.mark.parametrize("direction", ["ref-to-port", "port-to-ref"])
def test_cooc_index_loads_across_packages(tmp_path, direction):
    """A streaming index with a cold tier and sketches saved by one
    package and loaded by the other answers everything identically, and
    keeps ingesting identically."""
    t_idx = _build(TIndex, device="cpu", cold_store={})
    j_idx = _build(JIndex, cold_store={})
    for idx in (t_idx, j_idx):
        idx.ctx.term_signatures(num_perm=16)
    path = str(tmp_path / "snap")
    if direction == "ref-to-port":
        j_idx.save(path)
        saved, loaded = j_idx, TIndex.load(path, device="cpu")
        ref_side, port_side = saved, loaded
    else:
        t_idx.save(path)
        saved, loaded = t_idx, JIndex.load(path)
        ref_side, port_side = loaded, saved
    assert loaded.ctx.cold_blocks() == saved.ctx.cold_blocks() > 0
    np.testing.assert_array_equal(loaded._doc_time, saved._doc_time)
    assert _answers(port_side, "port") == _answers(ref_side, "ref")
    for idx in (port_side, ref_side):
        idx.add_documents(["fresh keyword networks from the index"],
                          timestamp=T0, source="late")
    assert (port_side.full_network(k=4, scope="late")
            == ref_side.full_network(k=4, scope="late"))
    assert _answers(port_side, "port") == _answers(ref_side, "ref")
