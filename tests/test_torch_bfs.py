"""The port's BFS construction, network helpers and engine against the JAX
reference.

Every comparison is exact: the same corpus (``synthetic_csl`` from a fixed
seed) goes into a ``repro`` and a ``repro_torch`` QueryContext, and the
fixed-shape networks must agree slot by slot — source, target, weight and
valid flag, which pins the top-k tie order too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.cooccurrence import chunked_top_k as j_chunked_top_k  # noqa: E402
from repro.data import synthetic_csl  # noqa: E402
from repro.serve import CoocEngine as JEngine  # noqa: E402
from repro_torch.serve import CoocEngine, EngineClosedError  # noqa: E402

V = 64
METHODS = ("gemm", "popcount", "pallas", "fused")


@pytest.fixture(scope="module")
def corpus():
    return synthetic_csl(400, V, seed=11)


@pytest.fixture(scope="module")
def contexts(corpus):
    j_ctx = J.QueryContext.from_docs(corpus, V)
    t_ctx = T.QueryContext.from_docs(corpus, V, device="cpu")
    for ctx in (j_ctx, t_ctx):
        ctx.tag_scope("even", np.arange(0, 400, 2))
    return t_ctx, j_ctx


def _slots(net):
    return np.stack([np.asarray(net.src).astype(np.int64),
                     np.asarray(net.dst).astype(np.int64),
                     np.asarray(net.weight).astype(np.int64),
                     np.asarray(net.valid).astype(np.int64)])


# ---------------------------------------------------------------------------
# top-k order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("v,k", [(64, 3),     # the reference's chunked path
                                 (256, 8),
                                 (50, 60),    # k > V: clamp, pad -1 / 0
                                 (7, 7)])
def test_chunked_top_k_tie_order(v, k):
    rng = np.random.default_rng(v + k)
    x = rng.integers(-2, 4, (5, v)).astype(np.int32)      # many ties
    w_want, i_want = j_chunked_top_k(jnp.asarray(x), k)
    w_got, i_got = T.chunked_top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(w_got.numpy(), np.asarray(w_want))
    np.testing.assert_array_equal(i_got.numpy(), np.asarray(i_want))
    if k <= v:
        w_lax, i_lax = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(i_got.numpy(), np.asarray(i_lax))


# ---------------------------------------------------------------------------
# construct / bfs_construct_batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scope", [None, "even"])
@pytest.mark.parametrize("method", METHODS)
def test_construct_matches_reference(contexts, method, scope):
    t_ctx, j_ctx = contexts
    kw = dict(seeds=(0, 9), depth=3, topk=5, beam=8, method=method,
              scope=scope)
    got = T.construct(t_ctx, T.QuerySpec(**kw))
    want = J.construct(j_ctx, J.QuerySpec(**kw))
    np.testing.assert_array_equal(_slots(got.network), _slots(want.network))
    assert got.edges() == want.edges()
    assert got.top(7) == want.top(7)
    assert got.nodes() == want.nodes()
    assert got.epoch == want.epoch


@pytest.mark.parametrize("method", ["popcount", "fused"])
def test_construct_without_dedup_and_topk_above_vocab(method):
    docs = synthetic_csl(120, 12, seed=2)
    t_ctx = T.QueryContext.from_docs(docs, 12, device="cpu")
    j_ctx = J.QueryContext.from_docs(docs, 12)
    kw = dict(seeds=(1,), depth=2, topk=20, beam=4, dedup=False,
              method=method)
    got = T.construct(t_ctx, T.QuerySpec(**kw))
    want = J.construct(j_ctx, J.QuerySpec(**kw))
    np.testing.assert_array_equal(_slots(got.network), _slots(want.network))


@pytest.mark.parametrize("method", ["gemm", "fused"])
def test_batch_major_bfs_matches_vmapped_reference(contexts, method):
    t_ctx, j_ctx = contexts
    seeds = np.array([[0, -1, -1], [5, 17, -1], [63, 2, 40]], np.int32)
    kw = dict(depth=2, topk=4, beam=6, method=method)
    got = T.bfs_construct_batch(t_ctx, torch.from_numpy(seeds), **kw)
    want = J.bfs_construct_batch(j_ctx, jnp.asarray(seeds), **kw)
    np.testing.assert_array_equal(_slots(got), _slots(want))


def test_host_oracles_match_reference_and_device(corpus):
    t_h = T.build_host_index(corpus, V)
    j_h = J.build_host_index(corpus, V)
    for seeds in ([0], [3, 30]):
        want = J.bfs_construct_host_fast(j_h, seeds, depth=3, topk=5, beam=8)
        assert T.bfs_construct_host_fast(t_h, seeds, depth=3, topk=5,
                                         beam=8) == want
    assert (T.traversal_construct_host(corpus[:50], V)
            == J.traversal_construct_host(corpus[:50], V))
    ctx = T.QueryContext.from_docs(corpus, V, device="cpu")
    res = T.construct(ctx, T.QuerySpec(seeds=(3,), depth=3, topk=5, beam=8,
                                       method="fused"))
    oracle = {}
    for s, d, w in T.bfs_construct_host_fast(t_h, [3], depth=3, topk=5,
                                             beam=8):
        key = (min(s, d), max(s, d))
        oracle[key] = max(oracle.get(key, 0), w)
    assert res.edges() == oracle


# ---------------------------------------------------------------------------
# network helpers
# ---------------------------------------------------------------------------


def test_network_helpers_match_reference():
    rng = np.random.default_rng(5)
    n = 40
    src = rng.integers(0, 9, n).astype(np.int32)
    dst = rng.integers(0, 9, n).astype(np.int32)
    valid = rng.random(n) < 0.7
    w = np.where(valid, rng.integers(1, 6, n), 0).astype(np.int32)
    jn = J.CoocNetwork(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                       jnp.asarray(valid))
    tn = T.CoocNetwork(torch.from_numpy(src), torch.from_numpy(dst),
                       torch.from_numpy(w), torch.from_numpy(valid))
    np.testing.assert_array_equal(_slots(T.merge_duplicates(tn, 9)),
                                  _slots(J.merge_duplicates(jn, 9)))
    np.testing.assert_array_equal(_slots(T.top_edges(tn, 11)),
                                  _slots(J.top_edges(jn, 11)))
    assert T.to_edge_dict(tn) == J.to_edge_dict(jn)
    for a, b in zip(T.to_edge_index(tn), J.to_edge_index(jn)):
        np.testing.assert_array_equal(a, b)
    assert T.nodes_of(tn) == J.nodes_of(jn)
    from repro.core.network import canonical_pairs
    for a, b in zip(T.canonical_pairs(tn), canonical_pairs(jn)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_query_surface_matches_reference():
    req = {"seeds": [4, 2], "depth": 2, "method": "fused", "scope": "s"}
    t_spec = T.canonicalize_request(req, defaults={"topk": 3, "bogus": 1})
    j_spec = J.canonicalize_request(req, defaults={"topk": 3, "bogus": 1})
    assert t_spec.plan_key == j_spec.plan_key
    assert T.canonical_exec_key(t_spec.plan_key) == \
        tuple(J.canonical_exec_key(j_spec.plan_key))
    np.testing.assert_array_equal(t_spec.seed_row(), j_spec.seed_row())
    assert T.canonicalize_request([7]).seeds == (7,)
    for bad in ({"seeds": [1], "nope": 2}, {"depth": 2}):
        with pytest.raises(ValueError):
            T.canonicalize_request(bad)
    for kw in ({"seeds": ()}, {"seeds": (-1,)}, {"seeds": (1,), "topk": 0},
               {"seeds": (1, 2), "beam": 1}, {"seeds": (1,), "method": "x"}):
        with pytest.raises(ValueError):
            T.QuerySpec(**kw)
    assert T.count_method_names() == J.count_method_names()


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def test_engine_mixed_plans_equal_construct(contexts):
    """Micro-batches of mixed plans (methods, widths, scopes) resolve every
    future to exactly construct(ctx, spec), and to the reference engine."""
    t_ctx, j_ctx = contexts
    specs = [dict(seeds=(s,), depth=2, topk=4, beam=8, method=m, scope=sc)
             for s, m, sc in [(0, "fused", None), (3, "gemm", "even"),
                              (5, "fused", None), (7, "pallas", "even"),
                              (9, "fused", "even"), (11, "popcount", None),
                              (13, "fused", None)]]
    eng = CoocEngine(t_ctx, device="cpu", q_batch=2)
    jeng = JEngine(j_ctx, q_batch=2)
    futs = [eng.submit(T.QuerySpec(**kw)) for kw in specs]
    jfuts = [jeng.submit(J.QuerySpec(**kw)) for kw in specs]
    eng.run_until_drained()
    jeng.run_until_drained()
    for kw, f, jf in zip(specs, futs, jfuts):
        res = f.result()
        want = T.construct(t_ctx, T.QuerySpec(**kw))
        np.testing.assert_array_equal(_slots(res.network),
                                      _slots(want.network))
        np.testing.assert_array_equal(_slots(res.network),
                                      _slots(jf.result().network))
    # scoped and unscoped plans of one shape share an executor
    assert eng.compiled_plans == 4
    st = eng.stats()
    assert st.n == len(specs) and st.batches == eng.batches_total
    assert st.batches == jeng.stats().batches


def _engine(**kw):
    docs = synthetic_csl(80, 16, seed=5)
    ctx = T.QueryContext.from_docs(docs, 16, device="cpu")
    return CoocEngine(ctx, device="cpu", depth=2, topk=4, beam=8, q_batch=2,
                      **kw)


def test_engine_lru_compile_budget():
    eng = _engine(compile_budget=2)
    evicted = []
    eng.on_plan_evict = evicted.append
    first = eng.query([3])                       # plan A
    eng.query([3], depth=1)                      # plan B
    eng.query([3])                               # touch A: B is LRU
    eng.query([3], topk=2)                       # C evicts B
    assert eng.compiled_plans == 2 and eng.plan_evictions_total == 1
    assert evicted == [T.canonical_exec_key(
        eng.make_spec([3], depth=1).plan_key)]
    eng.query([3], depth=1)                      # B again evicts A
    assert eng.query([3]) == first               # A rebuilt, same answer
    assert eng.stats().plan_evictions == eng.plan_evictions_total == 3
    with pytest.raises(ValueError):
        _engine(compile_budget=0)


def test_engine_shutdown_lifecycle():
    eng = _engine()
    fut = eng.submit([3])
    eng.shutdown(drain=True)
    assert fut.done() and fut.result() is not None
    with pytest.raises(EngineClosedError, match="shut down"):
        eng.submit([3])
    eng = _engine()
    futs = [eng.submit([s]) for s in (1, 2, 3)]
    eng.shutdown(drain=False)
    for f in futs:
        assert f.done()
        with pytest.raises(EngineClosedError, match="before this"):
            f.result()
    assert eng.failed_total == 3 and eng.stats().failed_total == 3
    eng.shutdown()                               # idempotent
    assert eng.closed and not eng.queue


def test_engine_fails_only_the_plan_of_a_dropped_scope():
    eng = _engine()
    eng.ctx.tag_scope("tmp", [1, 2, 3])
    doomed = eng.submit([3], scope="tmp")
    kept = eng.submit([4])
    eng.ctx.drop_scope("tmp")
    eng.run_until_drained()
    with pytest.raises(KeyError):
        doomed.result()
    assert kept.result().edges() is not None
    with pytest.raises(KeyError, match="unknown scope"):
        eng.submit([3], scope="tmp")


@pytest.mark.parametrize("q_batch,seed_lists,drain,occupancy", [
    (2, [[3], [5], [7]], True, [2, 2, 1]),              # single seeds
    (2, [[1, 4, 9], [6]], True, [2, 2]),                # a multi-seed query
    (4, [[1], [2], [3], [4], [5]], True, [4] * 4 + [1]),  # 4, then 1
    (2, [[3], [8, 2]], False, [0, 0]),                  # flushed unserved
])
def test_request_surface_matches_reference(q_batch, seed_lists, drain,
                                           occupancy):
    """``CoocRequest.seed_terms`` and ``.batch_occupancy`` of every request
    in the finished log, in order, equal the reference engine's."""
    docs = synthetic_csl(80, 16, seed=5)
    engines = [cls(ctx, depth=2, topk=4, beam=8, q_batch=q_batch, **kw)
               for cls, ctx, kw in (
                   (CoocEngine, T.QueryContext.from_docs(docs, 16,
                                                         device="cpu"),
                    {"device": "cpu"}),
                   (JEngine, J.QueryContext.from_docs(docs, 16), {}))]
    logs = []
    for eng in engines:
        for seeds in seed_lists:
            eng.submit(seeds)
        logs.append(eng.run_until_drained() if drain
                    else eng.shutdown(drain=False))
    got, want = ([(r.rid, r.seed_terms, r.batch_occupancy) for r in log]
                 for log in logs)
    assert got == want
    assert got == [(i, s, o) for i, (s, o) in
                   enumerate(zip(seed_lists, occupancy))]
