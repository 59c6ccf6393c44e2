"""The port's cold tier against the JAX reference: the block codec, the
spill payloads, ``all_time_index``, ``materialize(scope="all-time")``,
``FileStorage`` and a reference context carried into the port mid-stream.

The same seeded numpy inputs go through ``repro`` and ``repro_torch`` on
the CPU; payload bytes, bits (uint32), ``doc_freq`` and networks (term
ids, weights and tie order, slot for slot) must be identical, and the
all-time network must equal that of a context that never evicted.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.api import CoocIndex as JIndex  # noqa: E402
from repro.core.snapshot import context_state  # noqa: E402
from repro.core.storage import FileStorage as JFileStorage  # noqa: E402
from repro.data import synthetic_csl  # noqa: E402
from repro_torch.api import CoocIndex as TIndex  # noqa: E402
from repro_torch.core import atomic_io  # noqa: E402
from repro_torch.core.inverted_index import to_uint32  # noqa: E402
from repro_torch.kernels.ref import popcount32  # noqa: E402

METHODS = ("gemm", "popcount", "pallas", "fused")
VOCAB = 48
DOCS = synthetic_csl(300, VOCAB, seed=11)
CORPUS = [
    "graph neural networks learn node embeddings from graph structure",
    "co-occurrence networks reveal semantic relationships in text corpora",
    "inverted index maps keywords to documents for fast retrieval",
    "breadth first search expands the network frontier level by level",
    "keyword co-occurrence networks support text mining and retrieval",
    "the inverted index makes co-occurrence network construction fast",
    "semantic networks and knowledge graphs organise scientific keywords",
    "fast retrieval of documents uses the inverted index keywords",
]


def _same_network(t_net, j_net, what=""):
    for field in ("src", "dst", "weight", "valid"):
        np.testing.assert_array_equal(
            np.asarray(getattr(t_net, field)),
            np.asarray(getattr(j_net, field)), err_msg=f"{what}/{field}")


def _same_index(t_idx, j_idx):
    np.testing.assert_array_equal(to_uint32(t_idx.packed),
                                  np.asarray(j_idx.packed))
    np.testing.assert_array_equal(t_idx.doc_freq.numpy(),
                                  np.asarray(j_idx.doc_freq))
    assert t_idx.n_docs == int(j_idx.n_docs)


def _same_stores(t_store, j_store):
    """Same keys, and byte-identical payloads under the one codec."""
    assert sorted(t_store) == sorted(j_store)
    for key in j_store:
        assert t_store[key] == j_store[key], key


def _windowed_pair(window, block, n_docs=len(DOCS), t_store=None,
                   j_store=None):
    """A port and a reference windowed context with cold stores, fed the
    same blocks of DOCS; returns them and the docs ingested."""
    t_ctx = T.QueryContext.from_docs(
        [], VOCAB, window=window, device="cpu",
        cold_store={} if t_store is None else t_store)
    j_ctx = J.QueryContext.from_docs(
        [], VOCAB, window=window, cold_store={} if j_store is None
        else j_store)
    for lo in range(0, n_docs, block):
        a = t_ctx.ingest_docs(DOCS[lo:lo + block])
        b = j_ctx.ingest_docs(DOCS[lo:lo + block])
        np.testing.assert_array_equal(a, b)
    return t_ctx, j_ctx, DOCS[:n_docs]


# ---------------------------------------------------------------------------
# the block codec and the spill payload
# ---------------------------------------------------------------------------


def test_encode_block_byte_equal_across_packages():
    rng = np.random.default_rng(0)
    packed = rng.integers(0, 2 ** 32, (3, 7), dtype=np.uint64).astype(
        np.uint32)
    df = rng.integers(0, 70, 7).astype(np.int32)
    t_blk = T.ColdBlock(packed, df, 70, 7)
    data = T.encode_block(t_blk)
    assert data == J.encode_block(J.ColdBlock(packed, df, 70, 7))
    for dec in (T.decode_block, J.decode_block):
        got = dec(data)
        np.testing.assert_array_equal(got.packed, packed)
        assert got.packed.dtype == np.uint32 and got.doc_freq.dtype == np.int32
        np.testing.assert_array_equal(got.doc_freq, df)
        assert (got.n_docs, got.vocab) == (70, 7)


@pytest.mark.parametrize("window,block", [(100, 37), (96, 45), (33, 33)])
def test_spill_payloads_equal_the_reference(window, block):
    """Blocks that straddle words, wrap the ring (a block's slots run
    past the top of the ring and on from 0) and set bit 31 spill to the
    same bytes in both packages."""
    t_ctx, j_ctx, _ = _windowed_pair(window, block)
    assert t_ctx.cold_blocks() == j_ctx.cold_blocks() > 2
    assert t_ctx.cold_version() == j_ctx.cold_version()
    assert t_ctx.evicted_docs_total == j_ctx.evicted_docs_total
    # the ring wrapped: more docs went through it than it has slots
    assert (t_ctx.evicted_docs_total + t_ctx.live_docs
            > t_ctx.index.capacity)
    assert t_ctx._ring_tail == j_ctx._ring_tail
    _same_stores(t_ctx.cold_store, j_ctx.cold_store)
    _same_index(t_ctx.index, j_ctx.index)
    for key in t_ctx.cold_store:
        blk = T.decode_block(t_ctx.cold_store[key])
        assert blk.packed.shape == (-(-blk.n_docs // 32), VOCAB)
        np.testing.assert_array_equal(
            blk.doc_freq, popcount32(T.from_uint32(blk.packed, "cpu"))
            .sum(0).numpy())


def _doc_rows(blk):
    """A cold block's docs as 0/1 rows (n_docs, vocab), in block order."""
    i = np.arange(blk.n_docs)
    return (blk.packed[i // 32] >> (i % 32).astype(np.uint32)[:, None]) & 1


def test_a_wrapping_block_spills_in_ring_order():
    """The spilled block's doc i is the block's i-th slot in ring order,
    also for a block that runs past the top slot and on from slot 0."""
    ctx = T.QueryContext.from_docs([], VOCAB, window=40, device="cpu",
                                   cold_store={})
    slots = [ctx.ingest_docs(DOCS[lo:lo + 20]) for lo in range(0, 120, 20)]
    assert slots[3][0] > slots[3][-1]                # 60..63, then 0..15
    blocks = [T.decode_block(ctx.cold_store[k])
              for k in sorted(ctx.cold_store)]
    assert [b.n_docs for b in blocks] == [20] * 4
    want = T.incidence_dense(T.pack_docs(DOCS[:80], VOCAB, device="cpu"),
                             torch.int32).numpy()[:80]
    np.testing.assert_array_equal(
        np.concatenate([_doc_rows(b) for b in blocks]), want)


# ---------------------------------------------------------------------------
# the all-time index and network
# ---------------------------------------------------------------------------


def test_all_time_index_bits_equal_the_reference():
    t_ctx, j_ctx, _ = _windowed_pair(40, 13)
    t_all, j_all = t_ctx.all_time_index(), j_ctx.all_time_index()
    _same_index(t_all, j_all)
    assert t_all.n_words == t_ctx.index.n_words + sum(
        T.decode_block(t_ctx.cold_store[k]).packed.shape[0]
        for k in t_ctx.cold_store)
    never = T.pack_docs(DOCS, VOCAB, device="cpu")
    assert torch.equal(t_all.doc_freq, never.doc_freq)
    live = T.QueryContext.from_docs(DOCS[:10], VOCAB, device="cpu")
    assert live.all_time_index() is live.index
    empty = T.QueryContext.from_docs(DOCS[:10], VOCAB, device="cpu",
                                     cold_store={})
    assert empty.all_time_index() is empty.index


@pytest.mark.parametrize("method", METHODS)
def test_all_time_network_equals_reference_and_never_evicted(method):
    t_ctx, j_ctx, docs = _windowed_pair(40, 13)
    never = T.QueryContext.from_docs(docs, VOCAB, device="cpu")
    got = T.materialize(t_ctx, k=4, method=method, scope="all-time")
    _same_network(got, J.materialize(j_ctx, k=4, method=method,
                                     scope="all-time"), method)
    _same_network(got, T.materialize(never, k=4, method=method), method)
    live = T.materialize(t_ctx, k=4, method=method)
    assert T.to_edge_dict(live) != T.to_edge_dict(got)


def test_all_time_without_a_spill_is_the_live_network():
    for store in (None, {}):
        ctx = T.QueryContext.from_docs(DOCS, VOCAB, device="cpu",
                                       cold_store=store)
        net = T.materialize(ctx, k=4, scope="all-time")
        _same_network(net, T.materialize(ctx, k=4), "no-spill")
        assert T.materialize(ctx, k=4) is net        # one cache entry


def test_all_time_cache_is_invalidated_by_a_spill():
    t_ctx = T.QueryContext.from_docs([], VOCAB, window=20, device="cpu",
                                     cold_store={})
    t_ctx.ingest_docs(DOCS[:20])
    t_ctx.ingest_docs(DOCS[20:30])                   # spills the first
    v1 = t_ctx.cold_version()
    net1 = T.materialize(t_ctx, k=4, method="popcount", scope="all-time")
    assert T.materialize(t_ctx, k=4, method="popcount",
                         scope="all-time") is net1
    t_ctx.ingest_docs(DOCS[30:45])                   # spills again
    assert t_ctx.cold_version() > v1
    net2 = T.materialize(t_ctx, k=4, method="popcount", scope="all-time")
    assert net2 is not net1
    never = T.QueryContext.from_docs(DOCS[:45], VOCAB, device="cpu")
    _same_network(net2, T.materialize(never, k=4, method="popcount"))
    assert T.to_edge_dict(net1) != T.to_edge_dict(net2)
    uncached = T.materialize(t_ctx, k=4, method="popcount",
                             scope="all-time", use_cache=False)
    assert uncached is not net2
    _same_network(uncached, net2)


def test_cold_blocks_of_another_vocab_width():
    """A block spilled under a narrower vocab pads up to the live one; a
    wider one drops an all-zero overhang and refuses postings in it."""
    first = [[0, 1], [1, 2], [2, 3], [0, 3]]
    second = [[0, 2], [1, 3]]
    pair = []
    for pkg, kw in ((T, {"device": "cpu"}), (J, {})):
        ctx = pkg.QueryContext.from_docs([], 4, capacity=64, window=4,
                                         cold_store={}, **kw)
        ctx.ingest_docs(first)
        ctx.ingest_docs(second)                      # spills under V 4
        ctx.grow_vocab(VOCAB)
        ctx.ingest_docs(DOCS[:2])
        pair.append(ctx)
    t_ctx, j_ctx = pair
    _same_index(t_ctx.all_time_index(), j_ctx.all_time_index())
    never = T.QueryContext.from_docs(first + second + DOCS[:2],
                                     t_ctx.vocab_size, capacity=64,
                                     device="cpu")
    _same_network(T.materialize(t_ctx, k=4, scope="all-time"),
                  T.materialize(never, k=4), "grown")

    wide = T.QueryContext.from_docs([], 64, window=4, device="cpu",
                                    cold_store={})
    wide.ingest_docs([[0, 1]] * 4)
    wide.ingest_docs([[1, 2]] * 4)                   # spills under V 64
    wide.retire_oldest_block()
    wide.shrink_vocab(4)
    assert wide.all_time_index().vocab_size == 4
    _same_network(T.materialize(wide, k=2, scope="all-time"),
                  T.materialize(T.QueryContext.from_docs(
                      [[0, 1]] * 4 + [[1, 2]] * 4, 4, device="cpu"), k=2))
    late = T.QueryContext.from_docs([], 64, window=4, device="cpu",
                                    cold_store={})
    late.ingest_docs([[0, 40]] * 4)
    late.retire_oldest_block()                       # term 40 goes cold
    late.shrink_vocab(4)
    with pytest.raises(ValueError, match="holds postings"):
        late.all_time_index()


def test_cooc_index_all_time_matches_reference():
    kw = dict(window=4, depth=2, topk=4, beam=8)
    t_idx = TIndex(device="cpu", cold_store={}, **kw)
    j_idx = JIndex(cold_store={}, **kw)
    for lo in range(0, len(CORPUS), 2):
        t_idx.add_documents(CORPUS[lo:lo + 2])
        j_idx.add_documents(CORPUS[lo:lo + 2])
    assert t_idx.ctx.cold_blocks() == j_idx.ctx.cold_blocks() > 0
    oracle = TIndex.from_texts(CORPUS, device="cpu", depth=2, topk=4, beam=8)
    got = t_idx.full_network(k=4, scope="all-time")
    assert got == j_idx.full_network(k=4, scope="all-time")
    assert got == oracle.full_network(k=4)
    assert got != t_idx.full_network(k=4)
    for got_f, want_f in zip(t_idx.network_stats(k=4, scope="all-time"),
                             oracle.network_stats(k=4)):
        np.testing.assert_array_equal(got_f, want_f)
    with pytest.raises(ValueError, match="reserved"):
        t_idx.add_documents(CORPUS[:1], source="all-time")


def test_cooc_index_cold_store_configs(tmp_path):
    idx = TIndex(device="cpu", window=2, cold_store={"type": "file",
                                                     "path": str(tmp_path)})
    assert isinstance(idx.ctx.cold_store, T.FileStorage)
    idx.add_documents(CORPUS[:2])
    idx.add_documents(CORPUS[2:4])
    assert sorted(os.listdir(tmp_path)) == ["block-00000000.bin"]
    store = {}
    assert TIndex(device="cpu", window=2,
                  cold_store=store).ctx.cold_store is store


# ---------------------------------------------------------------------------
# storage: FileStorage, make_storage, the atomic commit
# ---------------------------------------------------------------------------


def test_file_storage_durability_across_packages(tmp_path):
    store = T.make_storage({"type": "file", "path": str(tmp_path / "cold")})
    assert isinstance(store, T.FileStorage)
    t_ctx, j_ctx, _ = _windowed_pair(40, 13, t_store=store)
    assert len(store) == j_ctx.cold_blocks() > 0
    # a fresh handle, and the reference's class, over the same directory
    for again in (T.FileStorage(str(tmp_path / "cold")),
                  JFileStorage(str(tmp_path / "cold"))):
        _same_stores(again, j_ctx.cold_store)
        for key in again:
            assert isinstance(T.decode_block(again[key]), T.ColdBlock)
    # and the port reads a directory the reference spilled to
    ref_dir = str(tmp_path / "ref")
    _windowed_pair(40, 13, j_store=JFileStorage(ref_dir))
    _same_stores(T.FileStorage(ref_dir), store)


def test_file_storage_mapping_contract(tmp_path):
    s = T.FileStorage(str(tmp_path / "kv"))
    s["a-1"] = b"x"
    s["a-1"] = b"y"                                  # overwrite
    assert s["a-1"] == b"y" and len(s) == 1 and "a-1" in s
    assert list(s) == ["a-1"]
    del s["a-1"]
    assert len(s) == 0
    with pytest.raises(KeyError):
        s["a-1"]
    with pytest.raises(KeyError):
        del s["a-1"]
    for bad in ("../escape", "", "a/b"):
        with pytest.raises(KeyError, match="invalid"):
            s[bad] = b"z"


def test_make_storage_configs(tmp_path):
    assert T.make_storage() == {} and T.make_storage({"type": "dict"}) == {}
    mine = {"block-0": b""}
    assert T.make_storage(mine) is mine              # a mapping passes
    with pytest.raises(ValueError, match="path"):
        T.make_storage({"type": "file"})
    with pytest.raises(ValueError, match="unknown cold-store type"):
        T.make_storage({"type": "redis"})


class _Crash(BaseException):
    """A simulated kill between two steps of the commit protocol."""


def test_file_storage_write_is_old_or_new_at_every_crash(tmp_path,
                                                         monkeypatch):
    """A crash before any low-level step of a block's commit leaves the
    key holding the complete old payload or the complete new one."""
    names = ("fsync_file", "fsync_path", "rename", "replace")
    steps = {"n": 0, "at": None}
    for name in names:
        orig = getattr(atomic_io, name)

        def wrapped(*a, _orig=orig, **kw):
            if steps["at"] is not None and steps["n"] == steps["at"]:
                raise _Crash
            steps["n"] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(atomic_io, name, wrapped)
    old, new = b"old" * 100, b"new" * 200
    probe = T.FileStorage(str(tmp_path / "probe"))
    probe["k"] = old
    steps["n"] = 0
    probe["k"] = new
    total = steps["n"]
    assert total >= 3                                # fsync, replace, fsync
    seen = set()
    for k in range(total):
        s = T.FileStorage(str(tmp_path / f"crash-{k}"))
        steps["at"] = None
        s["k"] = old
        steps["n"], steps["at"] = 0, k
        with pytest.raises(_Crash):
            s["k"] = new
        got = s["k"]
        assert got in (old, new)
        seen.add(got)
        assert list(s) == ["k"]                      # no temp file listed
    assert seen == {old, new}


def test_staged_dir_commits_or_leaves_the_target(tmp_path):
    final = tmp_path / "snap"
    with atomic_io.staged_dir(str(final)) as tmp:
        atomic_io.atomic_write_text(os.path.join(tmp, "a.txt"), "one")
    assert (final / "a.txt").read_text() == "one"
    with pytest.raises(RuntimeError):
        with atomic_io.staged_dir(str(final)) as tmp:
            atomic_io.atomic_write_bytes(os.path.join(tmp, "a.txt"), b"two")
            raise RuntimeError("failed mid-write")
    assert (final / "a.txt").read_text() == "one"
    assert sorted(os.listdir(tmp_path)) == ["snap"]
    other = tmp_path / "other"
    other.mkdir()
    (other / "b.txt").write_text("three")
    atomic_io.commit_dir(str(other), str(final))     # replaces the target
    assert sorted(os.listdir(final)) == ["b.txt"]


# ---------------------------------------------------------------------------
# a reference context carried into the port mid-stream
# ---------------------------------------------------------------------------


def _continue_both(t_ctx, j_ctx):
    """The same next steps on both; after each, the same ring, payloads,
    queries and all-time network."""
    steps = [lambda c: c.ingest_docs(DOCS[:13], scope="late"),
             lambda c: c.set_window(30),
             lambda c: c.ingest_docs(DOCS[13:30]),
             lambda c: c.retire_oldest_block(),
             lambda c: c.set_window(70),
             lambda c: c.ingest_docs(DOCS[30:80])]
    for step in steps:
        step(t_ctx)
        step(j_ctx)
        _same_index(t_ctx.index, j_ctx.index)
        for attr in ("window", "_ring_tail", "_stranded", "epoch",
                     "evicted_docs_total", "live_docs"):
            assert getattr(t_ctx, attr) == getattr(j_ctx, attr), attr
        np.testing.assert_array_equal(t_ctx.live_slots(), j_ctx.live_slots())
        assert t_ctx.cold_version() == j_ctx.cold_version()
        _same_stores(t_ctx.cold_store, j_ctx.cold_store)
        for name in j_ctx.scope_names():
            np.testing.assert_array_equal(to_uint32(t_ctx.scope(name)),
                                          np.asarray(j_ctx.scope(name)))
    seed = int(np.argmax(np.asarray(j_ctx.index.doc_freq)))
    for method in METHODS:
        kw = dict(seeds=(seed,), depth=2, topk=4, beam=8, method=method,
                  scope="late")
        _same_network(T.construct(t_ctx, T.QuerySpec(**kw)).network,
                      J.construct(j_ctx, J.QuerySpec(**kw)).network, method)
        _same_network(T.materialize(t_ctx, k=4, method=method,
                                    scope="all-time"),
                      J.materialize(j_ctx, k=4, method=method,
                                    scope="all-time"), method)


def _reference_mid_stream(store):
    j_ctx = J.QueryContext.from_docs([], VOCAB, window=45, cold_store=store)
    for lo in range(0, 100, 13):
        j_ctx.ingest_docs(DOCS[lo:lo + 13], scope="odd" if lo % 2 else None)
    assert j_ctx.cold_blocks() > 2 and j_ctx._ring_tail
    return j_ctx


def test_reference_state_with_its_payloads_continues_in_the_port():
    j_ctx = _reference_mid_stream({})
    arrays, meta = context_state(j_ctx)
    t_ctx = T.context_from_state(arrays, meta, device="cpu")
    assert t_ctx.window == j_ctx.window == 45
    _same_stores(t_ctx.cold_store, j_ctx.cold_store)
    _continue_both(t_ctx, j_ctx)


def test_reference_cold_directory_continues_in_the_port(tmp_path):
    """The state without its payloads, beside a copy of the directory
    the reference spilled to: the port reads and extends that store."""
    j_ctx = _reference_mid_stream(JFileStorage(str(tmp_path / "ref")))
    arrays, meta = context_state(j_ctx)
    arrays = {k: v for k, v in arrays.items() if not k.startswith("cold_")}
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    t_ctx = T.context_from_state(arrays, meta, device="cpu",
                                 cold_store=T.FileStorage(
                                     str(tmp_path / "port")))
    _continue_both(t_ctx, j_ctx)
    with pytest.raises(KeyError, match="neither"):
        T.context_from_state(arrays, meta, device="cpu", cold_store={})
