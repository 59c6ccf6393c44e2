"""The port's whole-corpus materialization against the JAX reference.

The same numpy corpora (fixed seeds) go through ``repro.core.materialize``
and ``repro_torch.core.materialize`` on the CPU, for all four count
methods; the ``V * k`` edge slots (src, dst, weight, valid) must be
identical, as must the network statistics computed from them.  The
reference's ``"pallas"`` runs its Pallas kernel in interpret mode, as its
own tests run it; the port's runs the kernel's plain version.  Every
comparison is exact: the counts are integers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.materialize import materialize as j_materialize  # noqa: E402
from repro_torch.core import materialize  # noqa: E402

METHODS = ("gemm", "popcount", "pallas", "fused")


def _corpus(n_docs, vocab, seed, flavor):
    """Random docs; ``flavor`` forces a nasty shape:

    * ``"ties"``: every doc holding term 2j holds 2j+1 too, so the two
      postings columns are identical and every count against them ties;
    * ``"empty"``: term ``vocab // 2`` never occurs;
    * ``"zero_block"``: only terms below 128 occur, so the last row block
      of a vocabulary above 128 has no postings at all."""
    rng = np.random.default_rng(seed)
    hi = min(vocab, 128) if flavor == "zero_block" else vocab
    docs = []
    for _ in range(n_docs):
        d = rng.integers(0, hi, int(rng.integers(0, 9))).tolist()
        if flavor == "ties":
            d = d + [t + 1 for t in d if t % 2 == 0 and t + 1 < vocab]
        if flavor == "empty":
            d = [t for t in d if t != vocab // 2]
        docs.append(d)
    return docs


def _slots(net):
    return tuple(np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
                 for x in net)


def _same_net(ours, ref):
    for got, want in zip(_slots(ours), _slots(ref)):
        np.testing.assert_array_equal(got, want)


def _contexts(docs, vocab):
    return (T.QueryContext.from_docs(docs, vocab, device="cpu"),
            J.QueryContext.from_docs(docs, vocab))


@pytest.mark.parametrize("n_docs,vocab,flavor,ks", [
    (1, 2, "plain", (1, 4)),             # one doc, k > V
    (40, 9, "ties", (1, 4, 16)),         # forced ties, k > V
    (120, 33, "empty", (4, 16, 40)),     # an empty term, k > V
    (300, 130, "zero_block", (4, 16)),   # an all-zero row block
    (200, 64, "plain", (1, 16)),
])
@pytest.mark.parametrize("method", METHODS)
def test_materialize_matches_reference(n_docs, vocab, flavor, ks, method):
    docs = _corpus(n_docs, vocab, seed=n_docs + vocab, flavor=flavor)
    t_ctx, j_ctx = _contexts(docs, vocab)
    for k in ks:
        net = materialize(t_ctx, k=k, method=method)
        assert net.src.shape == (vocab * k,)
        _same_net(net, j_materialize(j_ctx, k=k, method=method))


@pytest.mark.parametrize("method", METHODS)
def test_scoped_materialize_matches_reference(method):
    docs = _corpus(150, 40, seed=5, flavor="plain")
    t_ctx, j_ctx = _contexts(docs, 40)
    for ctx in (t_ctx, j_ctx):
        ctx.tag_scope("odd", np.arange(1, 150, 2))
    _same_net(materialize(t_ctx, k=5, method=method, scope="odd"),
              j_materialize(j_ctx, k=5, method=method, scope="odd"))
    bits = T.slots_bitmap(np.arange(0, 150, 3), t_ctx.index.n_words)
    _same_net(materialize(t_ctx, k=5, method=method, scope_mask=bits),
              j_materialize(j_ctx, k=5, method=method,
                            scope_mask=jnp.asarray(bits)))
    # a tensor bitmap is taken as well as a uint32 array
    _same_net(materialize(t_ctx, k=5, method=method,
                          scope_mask=T.from_uint32(bits, "cpu")),
              j_materialize(j_ctx, k=5, method=method,
                            scope_mask=jnp.asarray(bits)))


def test_cache_warm_is_cold_and_ingest_invalidates():
    docs = _corpus(80, 20, seed=6, flavor="plain")
    t_ctx, j_ctx = _contexts(docs, 20)
    cold = {m: materialize(t_ctx, k=4, method=m) for m in METHODS}
    for m in METHODS:
        assert materialize(t_ctx, k=4, method=m) is cold[m]    # warm hit
    assert t_ctx.unpack_count <= 1          # one dense build in all
    assert materialize(t_ctx, k=4, method="gemm", use_cache=False) \
        is not cold["gemm"]
    t_ctx.tag_scope("s", [0, 1, 2])
    scoped = materialize(t_ctx, k=4, method="popcount", scope="s")
    assert materialize(t_ctx, k=4, method="popcount", scope="s") is scoped
    t_ctx.tag_scope("s", [3])               # redefinition: a miss
    assert materialize(t_ctx, k=4, method="popcount", scope="s") \
        is not scoped
    fresh = [[0, 1, 2], [1, 2], [0, 19]]
    t_ctx.ingest_docs(fresh)
    j_ctx.ingest_docs(fresh)
    for m in METHODS:
        net = materialize(t_ctx, k=4, method=m)
        assert net is not cold[m]
        _same_net(net, j_materialize(j_ctx, k=4, method=m))
    assert t_ctx.unpack_count == 2          # rebuilt once for the new epoch


@pytest.mark.parametrize("method", METHODS)
def test_bare_index_matches_reference(method):
    docs = _corpus(90, 21, seed=7, flavor="ties")
    t_net = materialize(T.pack_docs(docs, 21, device="cpu"), k=3,
                        method=method)
    _same_net(t_net, j_materialize(J.pack_docs(docs, 21), k=3,
                                   method=method))


def test_row_tile_does_not_change_the_network():
    docs = _corpus(100, 50, seed=8, flavor="plain")
    t_ctx, _ = _contexts(docs, 50)
    want = materialize(t_ctx, k=6, method="pallas")
    for row_tile in (8, 24, 1000):
        _same_net(materialize(t_ctx, k=6, method="pallas",
                              row_tile=row_tile), want)


def _count_launches(monkeypatch):
    """Count the co-occurrence calls of method "pallas" (on the CPU the
    wrapper runs the plain version, which LAUNCHES does not count)."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.cooccur_counts

    def counted(x_l, x_r):
        calls.append(x_l.shape[1])
        return real(x_l, x_r)

    monkeypatch.setattr(ops, "cooccur_counts", counted)
    return calls


@pytest.mark.parametrize("vocab,row_tile", [
    (70, 8),      # 9 row blocks: groups of 4, 4 and a ragged 1
    (300, 16),    # 19 blocks, the last one ragged (300 = 18 * 16 + 12)
])
def test_grouped_sweep_matches_reference(monkeypatch, vocab, row_tile):
    """Method "pallas" hands the kernel GROUP row blocks a launch; a V that
    is not a multiple of GROUP * row_tile gives the reference's network
    exactly, in ceil(V / (GROUP * row_tile)) launches."""
    from repro_torch.core.materialize import GROUP
    assert vocab % (GROUP * row_tile)
    docs = _corpus(250, vocab, seed=vocab, flavor="plain")
    t_ctx, j_ctx = _contexts(docs, vocab)
    calls = _count_launches(monkeypatch)
    net = materialize(t_ctx, k=6, method="pallas", row_tile=row_tile)
    assert len(calls) == -(-vocab // (GROUP * row_tile))
    assert calls[0] == min(GROUP * row_tile, vocab + (-vocab) % row_tile)
    _same_net(net, j_materialize(j_ctx, k=6, method="gemm"))


def test_grouped_scoped_sweep_matches_reference(monkeypatch):
    """The scope bitmap is ANDed into every row of a group."""
    from repro_torch.core.materialize import GROUP
    docs = _corpus(200, 90, seed=12, flavor="ties")
    t_ctx, j_ctx = _contexts(docs, 90)
    for ctx in (t_ctx, j_ctx):
        ctx.tag_scope("odd", np.arange(1, 200, 2))
    calls = _count_launches(monkeypatch)
    net = materialize(t_ctx, k=5, method="pallas", scope="odd", row_tile=8)
    assert len(calls) == -(-90 // (GROUP * 8))
    _same_net(net, j_materialize(j_ctx, k=5, method="gemm", scope="odd"))


def test_statistics_match_reference():
    from repro.core.network import (degree_histogram as j_hist,
                                    edge_jaccard as j_jaccard,
                                    global_statistics as j_stats)
    docs = _corpus(200, 48, seed=9, flavor="ties")
    t_ctx, j_ctx = _contexts(docs, 48)
    t_nets = [materialize(t_ctx, k=k, method="pallas") for k in (2, 6)]
    j_nets = [j_materialize(j_ctx, k=k, method="pallas") for k in (2, 6)]
    for t_net, j_net in zip(t_nets, j_nets):
        got, want = T.global_statistics(t_net, 48), j_stats(j_net, 48)
        assert got._fields == want._fields
        for name, a, b in zip(got._fields, got, want):
            np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(T.degree_histogram(got), j_hist(want))
    assert T.edge_jaccard(*t_nets) == j_jaccard(*j_nets)
    assert T.edge_jaccard(t_nets[0], t_nets[0]) == 1.0
    empty = materialize(T.QueryContext.from_docs([[]], 4, device="cpu"), k=2)
    stats = T.global_statistics(empty, 4)
    assert stats.n_edges == 0 and stats.density == 0.0
    np.testing.assert_array_equal(T.degree_histogram(stats), [0])
    assert T.edge_jaccard(empty, empty) == 1.0


def test_argument_checks_and_unported_modes():
    ctx = T.QueryContext.from_docs([[0, 1], [1, 2]], 3, device="cpu")
    for kw, err in [({"k": 0}, "k must be"), ({"method": "nope"}, "unknown"),
                    ({"scope": "a", "scope_mask": np.zeros(1, np.uint32)},
                     "not both"),
                    ({"shard_strategy": "diag"}, "shard_strategy"),
                    ({"mode": "bogus"}, "mode must be"),
                    ({"mode": "approx", "shard_strategy": "rows"},
                     "shard_strategy='rows'"),
                    ({"scope_mask": np.zeros(3, np.uint32)}, "shape")]:
        with pytest.raises(ValueError, match=err):
            materialize(ctx, **kw)
    with pytest.raises(ValueError, match="QueryContext"):
        materialize(ctx.index, scope="a")
    with pytest.raises(TypeError, match="CoocMesh"):
        materialize(ctx, mesh=object())
    # off a mesh the strategy is ignored, as in the reference
    _same_net(materialize(ctx, shard_strategy="rows", use_cache=False),
              materialize(ctx, use_cache=False))


def _zipf_docs(n_docs, vocab, seed, hole=None):
    """Zipf-skewed docs (the CSL corpus model's law): the head row group's
    terms reach nearly every doc, the tail groups' a few.  ``hole``
    (lo, hi) drops the terms of that range, so a group has no postings."""
    rng = np.random.default_rng(seed)
    p = 1.0 / (np.arange(1, vocab + 1) + 2.7) ** 1.15
    p /= p.sum()
    docs = [rng.choice(vocab, int(n), p=p).tolist()
            for n in np.clip(rng.poisson(6, n_docs), 1, None)]
    if hole is not None:
        docs = [[t for t in d if not hole[0] <= t < hole[1]] for d in docs]
    return docs


def _unions(docs, vocab, step, in_scope=None):
    """|U_g|: the docs (in the scope) holding a term of row group g."""
    held = np.zeros((len(docs), -(-vocab // step)), dtype=bool)
    for i, d in enumerate(docs):
        if in_scope is None or i in in_scope:
            held[i, [t // step for t in d]] = True
    return held.sum(0)


def _count_operands(monkeypatch):
    """Record each co-occurrence call's (docs, rows): the doc axis it
    counts over and its row group's rows."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.cooccur_counts

    def counted(x_l, x_r):
        calls.append(tuple(x_l.shape))
        return real(x_l, x_r)

    monkeypatch.setattr(ops, "cooccur_counts", counted)
    return calls


def _pad16(n):
    return -(-n // 16) * 16


@pytest.mark.parametrize("scoped", [False, True])
@pytest.mark.parametrize("hole", [None, (640, 768)])
def test_compacted_sweep_counts_each_group_over_its_docs(monkeypatch, scoped,
                                                         hole):
    """Method "pallas" counts each row group over the docs holding one of
    its terms (in the scope): the reference's exact network, one launch a
    group with any doc, none for a group without postings, and no dense
    incidence built."""
    from repro_torch.core.materialize import GROUP
    vocab, row_tile = 1024, 32                   # 8 groups of 128 terms
    step = GROUP * row_tile
    docs = _zipf_docs(400, vocab, seed=31, hole=hole)
    t_ctx, j_ctx = _contexts(docs, vocab)
    scope, in_scope = None, None
    if scoped:
        scope, in_scope = "odd", set(range(1, 400, 2))
        for ctx in (t_ctx, j_ctx):
            ctx.tag_scope(scope, np.arange(1, 400, 2))
    unions = _unions(docs, vocab, step, in_scope)
    n_scope = 400 if in_scope is None else len(in_scope)
    assert unions[0] >= 0.95 * n_scope and unions[-1] <= 0.3 * n_scope
    assert (unions[5] == 0) == (hole is not None)
    calls = _count_operands(monkeypatch)
    net = materialize(t_ctx, k=8, method="pallas", row_tile=row_tile,
                      scope=scope)
    _same_net(net, j_materialize(j_ctx, k=8, method="gemm", scope=scope))
    assert calls == [(_pad16(u), step) for u in unions if u]
    assert t_ctx.unpack_count == 0


def test_compacted_sweep_after_an_ingest():
    """The forward index is an epoch artifact: an ingest rebuilds it, and
    the next sweep counts the new docs."""
    docs = _zipf_docs(300, 512, seed=32)
    t_ctx, j_ctx = _contexts(docs, 512)
    _same_net(materialize(t_ctx, k=6, method="pallas", row_tile=16),
              j_materialize(j_ctx, k=6, method="gemm"))
    fwd = t_ctx.forward_index()
    assert fwd.nnz == sum(len(set(d)) for d in docs)
    fresh = [[0, 511, 300], [511, 7], [300, 301, 0, 7]]
    t_ctx.ingest_docs(fresh)
    j_ctx.ingest_docs(fresh)
    _same_net(materialize(t_ctx, k=6, method="pallas", row_tile=16),
              j_materialize(j_ctx, k=6, method="gemm"))
    assert t_ctx.forward_index() is not fwd
    assert t_ctx.forward_index().nnz == fwd.nnz + 9
    assert t_ctx.unpack_count == 0


def test_compacted_sweep_beside_a_built_x_dense(monkeypatch):
    """Where "gemm" built the epoch's x_dense, "pallas" still stages every
    group over its own docs (its staging is bounded by a chunk, so the
    dense incidence is not read); each masks span carries the docs its
    group counts over."""
    import importlib
    mat = importlib.import_module("repro_torch.core.materialize")
    from repro_torch import tracing
    vocab, row_tile = 1024, 32
    step = mat.GROUP * row_tile
    docs = _zipf_docs(400, vocab, seed=33)
    t_ctx, j_ctx = _contexts(docs, vocab)
    want = j_materialize(j_ctx, k=8, method="gemm")
    _same_net(materialize(t_ctx, k=8, method="gemm"), want)
    assert t_ctx.unpack_count == 1
    unions = _unions(docs, vocab, step)
    calls = _count_operands(monkeypatch)
    tracing.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        net = materialize(t_ctx, k=8, method="pallas", row_tile=row_tile)
    _same_net(net, want)
    assert calls == [(_pad16(u), step) for u in unions if u]
    docs_attr = [s[4]["docs"] for s in tracing.spans()
                 if s[0] == "cooc.materialize.masks"]
    tracing.clear()
    assert docs_attr == unions.tolist()
    assert t_ctx.unpack_count == 1


def _chunks(u, chunk):
    """The doc counts of the chunks a union of ``u`` docs is counted in."""
    return [chunk] * (u // chunk) + ([u % chunk] if u % chunk else [])


def _traced_pallas(t_ctx, monkeypatch, **kw):
    """The "pallas" network of ``t_ctx``, each co-occurrence call's
    (docs, rows), and the (name, attrs) of its masks and chunk spans."""
    from repro_torch import tracing
    calls = _count_operands(monkeypatch)
    tracing.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        net = materialize(t_ctx, method="pallas", use_cache=False, **kw)
    spans = [(s[0], s[4]) for s in tracing.spans()
             if s[0] in ("cooc.materialize.masks", "cooc.materialize.chunk")]
    tracing.clear()
    return net, calls, spans


def _check_chunks(calls, spans, unions, step, chunk, n_rows):
    """Every launch counts at most ``chunk`` docs; each group's chunk
    spans run over its union in order, one masks span a group."""
    masks = [a for n, a in spans if n == "cooc.materialize.masks"]
    assert [a["docs"] for a in masks] == list(unions)
    by_group = {}
    for n, a in spans:
        if n == "cooc.materialize.chunk":
            by_group.setdefault(a["r0"], []).append((a["c0"], a["docs"]))
    want_calls = []
    for g, u in enumerate(unions):
        sizes = _chunks(int(u), chunk)
        got = by_group.get(g * step, [])
        assert [d for _, d in got] == sizes
        assert [c for c, _ in got] == list(np.cumsum([0] + sizes[:-1]))
        want_calls += [(_pad16(d), min(step, n_rows - g * step))
                       for d in sizes]
    assert calls == want_calls
    assert all(k <= chunk for k, _ in calls)


@pytest.mark.parametrize("case", ["multiple", "one_left", "short_last",
                                  "short_rows", "scoped"])
def test_chunked_sweep_matches_reference(monkeypatch, case):
    """Unions past DOC_CHUNK are counted in chunks whose counts add up to
    the reference's network bit for bit: a head union of exactly three
    chunks, one of two chunks and one doc, a vocabulary whose last group
    is short in terms (1,000 at row tile 32) or in rows (row tile 40),
    and a scope."""
    import importlib
    mat = importlib.import_module("repro_torch.core.materialize")
    chunk = 32
    monkeypatch.setattr(mat, "DOC_CHUNK", chunk)
    vocab, row_tile, n_docs = 512, 32, 96
    if case == "one_left":
        n_docs = 97
    if case in ("short_last", "short_rows"):
        vocab, n_docs = 1000, 150
    if case == "short_rows":
        row_tile = 40
    if case == "scoped":
        n_docs = 200
    docs = _zipf_docs(n_docs, vocab, seed=34)
    docs = [[0] + d for d in docs]        # the head group holds every doc
    t_ctx, j_ctx = _contexts(docs, vocab)
    scope, in_scope = None, None
    if case == "scoped":
        in_scope = set(range(0, n_docs, 3)) | {1, 2}
        scope = "some"
        for ctx in (t_ctx, j_ctx):
            ctx.tag_scope(scope, np.asarray(sorted(in_scope)))
    step = mat.GROUP * row_tile
    n_rows = -(-vocab // row_tile) * row_tile
    unions = _unions(docs, n_rows, step, in_scope)
    assert unions[0] == (n_docs if in_scope is None else len(in_scope))
    assert unions[0] > 2 * chunk
    net, calls, spans = _traced_pallas(t_ctx, monkeypatch, k=8,
                                       row_tile=row_tile, scope=scope)
    _same_net(net, j_materialize(j_ctx, k=8, method="gemm", scope=scope))
    _check_chunks(calls, spans, unions, step, chunk, n_rows)
    if case == "multiple":
        assert unions[0] == 3 * chunk
    if case == "one_left":
        assert unions[0] == 3 * chunk + 1
    if case == "short_last":
        assert vocab % step and not n_rows % step
    if case == "short_rows":
        assert n_rows % step
    assert t_ctx.unpack_count == 0


def test_chunked_sweep_after_an_ingest(monkeypatch):
    """An ingest moves the epoch: the next chunked sweep's plan counts
    the new docs."""
    import importlib
    mat = importlib.import_module("repro_torch.core.materialize")
    monkeypatch.setattr(mat, "DOC_CHUNK", 32)
    docs = _zipf_docs(100, 512, seed=35)
    t_ctx, j_ctx = _contexts(docs, 512)
    _same_net(materialize(t_ctx, k=6, method="pallas", row_tile=16),
              j_materialize(j_ctx, k=6, method="gemm"))
    fresh = _zipf_docs(28, 512, seed=36)
    t_ctx.ingest_docs(fresh)
    j_ctx.ingest_docs(fresh)
    unions = _unions(docs + fresh, 512, mat.GROUP * 16)
    net, calls, spans = _traced_pallas(t_ctx, monkeypatch, k=6, row_tile=16)
    _same_net(net, j_materialize(j_ctx, k=6, method="gemm"))
    _check_chunks(calls, spans, unions, mat.GROUP * 16, 32, 512)
    assert unions[0] > 64


def test_chunked_sweep_over_a_window_that_evicted(monkeypatch):
    """A window that has evicted blocks reuses their slots: the forward
    index and the plan are rebuilt from the ring, and the chunked network
    is the reference's."""
    import importlib
    mat = importlib.import_module("repro_torch.core.materialize")
    monkeypatch.setattr(mat, "DOC_CHUNK", 16)
    vocab = 300
    t_ctx = T.QueryContext.from_docs([], vocab, device="cpu", window=96)
    j_ctx = J.QueryContext.from_docs([], vocab, window=96)
    blocks = [_zipf_docs(40, vocab, seed=40 + i) for i in range(4)]
    for i, block in enumerate(blocks):
        for ctx in (t_ctx, j_ctx):
            ctx.ingest_docs(block)
        if i == 1:
            _same_net(materialize(t_ctx, k=5, method="pallas", row_tile=16),
                      j_materialize(j_ctx, k=5, method="gemm"))
    assert t_ctx.evicted_docs_total == j_ctx.evicted_docs_total == 80
    live = [d for b in blocks[2:] for d in b]
    step = mat.GROUP * 16
    unions = _unions(live, 304, step)
    net, calls, spans = _traced_pallas(t_ctx, monkeypatch, k=5, row_tile=16)
    _same_net(net, j_materialize(j_ctx, k=5, method="gemm"))
    _check_chunks(calls, spans, unions, step, 16, 304)
    assert unions[0] > 32


def test_plan_positions_past_int32():
    """A chunk's operand positions are int64 and exact past 2^31: the
    plan's arithmetic at a union of 2^34 docs, with no operand built."""
    from repro_torch.core.materialize import _chunk_geometry, _k_pad
    chunk = 1 << 17
    n_union = torch.tensor([1 << 34, (1 << 34) + 5, (1 << 34) + 5])
    i = torch.tensor([(1 << 33) + 7, (1 << 34) + 4, 3 * chunk + 1])
    kp, col = _chunk_geometry(i, n_union, chunk)
    assert kp.tolist() == [chunk, _k_pad(5), chunk]
    assert col.tolist() == [7, 4, 1]
    # the last one of a (65,535 x K_pad) operand: past 2^31
    pos = torch.tensor([65535]) * kp[:1] + (chunk - 1)
    assert pos.dtype == torch.int64 and pos.item() == 65536 * chunk - 1
    assert pos.item() > 2 ** 32


# ---------------------------------------------------------------------------
# the per-row top-k of a row block's counts (kernels.ops.row_top_k)
# ---------------------------------------------------------------------------


def _row_counts(case):
    """(counts (R, V) int32, r0, k) of one named case."""
    rng = np.random.default_rng(len(case))
    if case == "ties":                       # three values over 300 columns
        return rng.integers(0, 3, (6, 300)).astype(np.int32), 0, 16
    if case == "few_positive":               # 0-5 positives a row, k 16
        c = np.zeros((8, 400), np.int32)
        for r in range(8):
            c[r, rng.choice(400, r % 6, replace=False)] = rng.integers(
                1, 4, r % 6)
        return c, 100, 16
    if case == "all_zero":
        return np.zeros((4, 256), np.int32), 7, 8
    if case == "pad_rows":                   # rows r0 + r >= V hide V - 1
        return rng.integers(0, 5, (8, 97)).astype(np.int32), 94, 16
    if case in ("v1000", "v30454"):          # Zipf-like rows
        v = int(case[1:])
        w = 1.0 / (np.arange(v) + 2.7) ** 1.15
        c = rng.poisson(w[None, :] * rng.uniform(50, 5000, (5, 1)) * 20)
        return c.astype(np.int32), v - 3, 17
    if case == "k_over_v":                   # clamp, pad -1 / 0
        return rng.integers(0, 4, (3, 50)).astype(np.int32), 10, 60
    assert case == "near_int32_max"
    c = (2 ** 31 - 1) - rng.integers(0, 3, (4, 333))
    return c.astype(np.int32), 40, 32


@pytest.mark.parametrize("case", ["ties", "few_positive", "all_zero",
                                  "pad_rows", "v1000", "v30454", "k_over_v",
                                  "near_int32_max"])
def test_row_top_k_matches_reference_chunked_top_k(case):
    """The plain version and the wrapper on a CPU tensor: each row's
    top-k with its self pair (column min(r0 + r, V - 1)) at -1, exactly
    the reference's ``chunked_top_k`` of the counts so masked by hand:
    values, ids and tie order; the counts are left as they were."""
    from repro.core.cooccurrence import chunked_top_k as j_chunked_top_k
    from repro_torch.kernels import ops, ref
    counts, r0, k = _row_counts(case)
    r, v = counts.shape
    masked = counts.copy()
    masked[np.arange(r), np.minimum(r0 + np.arange(r), v - 1)] = -1
    w_want, i_want = j_chunked_top_k(jnp.asarray(masked), k)
    x = torch.from_numpy(counts.copy())
    for fn in (ref.row_top_k_ref, ops.row_top_k):
        w, i = fn(x, r0, k)
        assert (w.dtype, i.dtype, tuple(w.shape)) == (
            torch.int32, torch.int64, (r, k))
        np.testing.assert_array_equal(w.numpy(), np.asarray(w_want))
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_want))
    np.testing.assert_array_equal(x.numpy(), counts)


def test_row_top_k_refuses_a_k_it_does_not_take():
    """The wrapper takes 1 <= k <= ROW_TOPK_MAX_K on every device; on
    ``meta`` it returns the outputs' shapes and charges one comparison a
    count and the counts' bytes."""
    from repro_torch.kernels import ops
    from repro_torch.launch.roofline import Counter
    x = torch.zeros((4, 200), dtype=torch.int32)
    for k in (0, ops.ROW_TOPK_MAX_K + 1):
        with pytest.raises(ValueError, match="row_top_k takes"):
            ops.row_top_k(x, 0, k)
    with Counter() as c:
        w, i = ops.row_top_k(x.to("meta"), 0, 16)
    assert (w.shape, i.shape, w.dtype, i.dtype) == (
        (4, 16), (4, 16), torch.int32, torch.int64)
    assert c.kernels["row_topk"]["launches"] == 1
    assert c.kernel_ops == 4 * 200


def test_sweep_reduces_each_group_through_the_row_top_k_wrapper(monkeypatch):
    """With the wrappers told the tensors are on the card (the kernels'
    plain versions in the launchers' place), the staged "pallas" sweep
    launches the row top-k once a row group with documents and "gemm"
    once a row block, for k up to the kernel's limit; a larger k keeps
    the plain top-k and launches nothing.  The networks are the
    reference's."""
    from repro_torch.kernels import cooccur, ops, ref, row_topk
    from repro_torch.core.materialize import GROUP
    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(cooccur, "cooccur_counts_cuda", lambda a, b: (
        ref.cooccur_counts_ref(a.t(), b.t()), "tma"))
    monkeypatch.setattr(row_topk, "row_top_k_cuda", ref.row_top_k_ref)
    vocab, row_tile = 1024, 32
    docs = _zipf_docs(300, vocab, seed=34, hole=(640, 768))
    t_ctx, j_ctx = _contexts(docs, vocab)
    groups = int((_unions(docs, vocab, GROUP * row_tile) > 0).sum())
    assert groups == vocab // (GROUP * row_tile) - 1
    for method, k, launched in (("pallas", 8, groups),
                                ("gemm", 8, vocab // row_tile),
                                ("pallas", ops.ROW_TOPK_MAX_K + 2, 0)):
        ops.reset_launches()
        net = materialize(t_ctx, k=k, method=method, row_tile=row_tile)
        assert ops.LAUNCHES["row_topk"] == launched, (method, k)
        _same_net(net, j_materialize(j_ctx, k=k, method="gemm"))
