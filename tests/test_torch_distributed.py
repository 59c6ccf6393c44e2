"""The port's term- and doc-sharded query mesh against the JAX reference.

A mesh of n shards is built over ``["cpu"] * n`` (one device repeated, as
one card runs a many-shard mesh), for n = 1, 2, 3, 4 and 8 and both shard
kinds.  Every sharded result must equal the reference's single-device
result exactly — counts, ids, weights and tie order, no tolerance — which
the reference's own harness (``tests/test_differential.py``) holds equal
to its sharded results; one subprocess test also runs the reference on 8
forced CPU devices and compares its meshed outputs with the port's
8-shard outputs directly.  The corpus has V = 29 terms, a multiple of no
shard count but 1, so the last shards are short or empty.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.serve import CoocEngine as JEngine  # noqa: E402
from repro_torch.core.distributed import ShardedIndex  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import CoocEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
V = 29
METHODS = ("gemm", "popcount", "pallas", "fused")
SHARDS = (1, 2, 3, 4, 8)
KINDS = ("terms", "docs")
SEEDS = np.asarray([[3, -1, -1, -1], [5, 7, -1, -1], [0, -1, -1, -1]],
                   np.int32)
PLAN = dict(depth=2, topk=4, beam=4)


def _docs(v, n_docs, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, v, rng.integers(1, 8)).tolist()
            for _ in range(n_docs)]


def _clustered_corpus(vocab, n_docs, cluster, density, n_noise, seed):
    """The reference harness's approx corpus (tests/test_differential.py)."""
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


DOCS = _docs(V, 70, 0)


def _slots(net):
    return np.stack([np.asarray(net.src).astype(np.int64),
                     np.asarray(net.dst).astype(np.int64),
                     np.asarray(net.weight).astype(np.int64),
                     np.asarray(net.valid).astype(np.int64)])


def _same(got, want, msg=""):
    np.testing.assert_array_equal(_slots(got), _slots(want), err_msg=msg)


def _mesh(n, kind):
    return T.make_cooc_mesh(devices=["cpu"] * n, shard=kind)


def _meshed(docs, v, n, kind, **kw):
    return T.QueryContext.from_docs(docs, v, device="cpu",
                                    mesh=_mesh(n, kind), **kw)


@pytest.fixture(scope="module")
def ref():
    """The reference's single-device answers on DOCS, computed once."""
    ctx = J.QueryContext.from_docs(DOCS, V)
    ctx.tag_scope("odd", np.arange(1, len(DOCS), 2))
    out = {}
    for m in METHODS:
        out["batch", m] = J.bfs_construct_batch(
            ctx, jnp.asarray(SEEDS), method=m, **PLAN)
        out["scoped", m] = J.construct(
            ctx, J.QuerySpec(seeds=(5, 7), method=m, scope="odd", **PLAN))
        for k in (4, 40):
            out["net", m, k] = J.materialize(ctx, k=k, method=m)
    return out


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------


def test_make_cooc_mesh_layouts_and_checks():
    m = T.make_cooc_mesh(devices=["cpu"] * 3)
    assert m.shape == {"data": 1, "model": 3} and T.shard_kind(m) == "terms"
    d = T.make_cooc_mesh(2, devices=["cpu"] * 3, shard="docs")
    assert d.shape == {"data": 2, "model": 1} and T.shard_kind(d) == "docs"
    assert T.n_shards(m) == 3 and T.n_shards(d) == 2
    assert m.axis_names == ("data", "model")
    # equality tells the shard count and the positions apart
    assert m == T.make_cooc_mesh(devices=["cpu"] * 3) != d
    assert m != T.make_cooc_mesh(devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="outside"):
        T.make_cooc_mesh(4, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="terms' or 'docs"):
        T.make_cooc_mesh(devices=["cpu"], shard="rows")
    with pytest.raises(ValueError, match="BOTH"):
        T.validate_mesh(T.CoocMesh(np.full((2, 2), "cpu", dtype=object)))
    with pytest.raises(ValueError, match="miss"):
        T.validate_mesh(T.CoocMesh([["cpu"]], ("x", "y")))
    with pytest.raises(AttributeError, match="frozen"):
        m.devices = None


def test_meshed_context_lives_on_the_first_device_and_checks_it(
        monkeypatch):
    ctx = _meshed(DOCS, V, 2, "terms")
    assert ctx.mesh == _mesh(2, "terms")
    assert ctx.device == torch.device("cpu")
    assert T.QueryContext.from_docs(DOCS, V, device="cpu").mesh is None
    # a meshed context on the card needs its first device, and a mesh
    # mixing CPU and CUDA devices is refused
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    mixed = T.CoocMesh([["cpu", "cuda:0"]])
    with pytest.raises(ValueError, match="mixes"):
        T.QueryContext(T.pack_docs(DOCS, V, device="cpu"), device="cpu",
                       mesh=mixed)
    with pytest.raises(ValueError, match="first device"):
        T.QueryContext(T.pack_docs(DOCS, V, device="cpu"), device="cuda",
                       mesh=_mesh(2, "terms"))


def test_shard_layout_term_and_doc():
    idx = T.pack_docs(DOCS, V, device="cpu")
    sh = ShardedIndex(idx, _mesh(3, "terms"))
    # ceil(29 / 3) = 10 columns, rounded up to 16 (multiples of 8)
    assert [(s.lo, s.hi) for s in sh.shards] == [(0, 16), (16, 29), (29, 29)]
    for s, part in zip(sh.shards, sh.parts):
        assert part.packed.is_contiguous()
        assert torch.equal(part.packed, idx.packed[:, s.lo:s.hi])
    sh = ShardedIndex(idx, _mesh(4, "docs"))
    w = idx.n_words
    assert [(s.lo, s.hi) for s in sh.shards][0] == (0, -(-w // 4))
    assert sh.shards[-1].hi == w
    x = T.dense_operand(idx)
    for s, xs in zip(sh.shards, sh.x_shards(x)):
        assert xs.stride(0) == 1 and xs.shape[0] == 32 * (s.hi - s.lo)


# ---------------------------------------------------------------------------
# the query path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SHARDS)
def test_bfs_construct_batch_matches_reference(ref, n, kind, method):
    """Context-carried mesh and explicit mesh= on a bare index."""
    want = ref["batch", method]
    ctx = _meshed(DOCS, V, n, kind)
    _same(T.bfs_construct_batch(ctx, torch.from_numpy(SEEDS), method=method,
                                **PLAN), want, f"{n}/{kind}/{method}")
    bare = T.pack_docs(DOCS, V, device="cpu")
    _same(T.bfs_construct_batch(bare, torch.from_numpy(SEEDS), method=method,
                                mesh=_mesh(n, kind), **PLAN), want)
    one = T.bfs_construct(ctx, torch.from_numpy(SEEDS[1]), method=method,
                          **PLAN)
    np.testing.assert_array_equal(
        _slots(one), _slots(want)[:, 1 * 32:2 * 32])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", (3,))
def test_engine_and_scoped_construct_match_reference(ref, n, kind):
    ctx = _meshed(DOCS, V, n, kind)
    ctx.tag_scope("odd", np.arange(1, len(DOCS), 2))
    eng = CoocEngine(ctx, device="cpu", q_batch=2, **PLAN)
    j_ctx = J.QueryContext.from_docs(DOCS, V)
    j_eng = JEngine(j_ctx, q_batch=2, **PLAN)
    specs = [((3,), dict(method="fused")), ((5, 7), {}),
             ((0,), dict(method="pallas")), ((9,), dict(method="fused"))]
    futs = [eng.submit(seeds, **kw) for seeds, kw in specs]
    j_futs = [j_eng.submit(seeds, **kw) for seeds, kw in specs]
    for f, jf in zip(futs, j_futs):
        _same(f.result().network, jf.result().network)
    for m in METHODS:
        spec = T.QuerySpec(seeds=(5, 7), method=m, scope="odd", **PLAN)
        _same(T.construct(ctx, spec).network, ref["scoped", m].network)


def test_self_mask_of_a_term_outside_the_shard():
    """Seeds in shard 0 whose best neighbor is shard 1's column 0: a
    seed's own column must never be masked in another shard (a clamp to a
    local id of 0 would drop the edge)."""
    v = 16                                  # 2 shards of 8 columns
    docs = [[1, 8]] * 5 + [[1, 3]] * 2 + [[8, 9]] * 3 + [[0, 8, 12]]
    seeds = np.asarray([[1, -1], [0, -1]], np.int32)
    want = J.bfs_construct_batch(J.QueryContext.from_docs(docs, v),
                                 jnp.asarray(seeds), depth=2, topk=3, beam=2,
                                 method="popcount")
    assert 8 in np.asarray(want.dst)[:3]
    for kind in KINDS:
        ctx = _meshed(docs, v, 2, kind)
        for m in METHODS:
            _same(T.bfs_construct_batch(ctx, torch.from_numpy(seeds),
                                        depth=2, topk=3, beam=2, method=m),
                  want, f"{kind}/{m}")


@pytest.mark.parametrize("kind", KINDS)
def test_vocab_smaller_than_the_mesh_and_k_past_v(kind):
    """V = 5 on 8 shards (three hold no column at all), top-k 7 > V."""
    docs = _docs(5, 30, 3)
    seeds = np.asarray([[2, -1, -1]], np.int32)
    j_ctx = J.QueryContext.from_docs(docs, 5)
    ctx = _meshed(docs, 5, 8, kind)
    for m in METHODS:
        want = J.bfs_construct_batch(j_ctx, jnp.asarray(seeds), depth=2,
                                     topk=7, beam=3, method=m)
        _same(T.bfs_construct_batch(ctx, torch.from_numpy(seeds), depth=2,
                                    topk=7, beam=3, method=m), want, m)
        for strategy in ("rows", "cols"):
            _same(T.materialize(ctx, k=7, method=m, shard_strategy=strategy),
                  J.materialize(j_ctx, k=7, method=m), f"{m}/{strategy}")


# ---------------------------------------------------------------------------
# materialization, sketches, the sharded kernel wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ("rows", "cols"))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SHARDS)
def test_materialize_exact_matches_reference(ref, n, kind, strategy):
    ctx = _meshed(DOCS, V, n, kind)
    for m in METHODS:
        for k in (4, 40):                     # 40 > V
            _same(T.materialize(ctx, k=k, method=m, shard_strategy=strategy,
                                row_tile=8), ref["net", m, k],
                  f"{n}/{kind}/{strategy}/{m}/{k}")


def test_materialize_cache_tells_meshes_apart():
    ctx = T.QueryContext.from_docs(DOCS, V, device="cpu")
    one = T.materialize(ctx, k=4)
    two = T.materialize(ctx, k=4, mesh=_mesh(2, "terms"))
    four = T.materialize(ctx, k=4, mesh=_mesh(4, "terms"))
    cols = T.materialize(ctx, k=4, mesh=_mesh(4, "terms"),
                         shard_strategy="cols")
    assert len({id(one), id(two), id(four), id(cols)}) == 4
    assert T.materialize(ctx, k=4, mesh=_mesh(4, "terms")) is four
    for net in (two, four, cols):
        _same(net, one)


@pytest.fixture(scope="module")
def approx_ref():
    docs = _clustered_corpus(96, 150, 16, 0.85, 1, 0)
    ctx = J.QueryContext.from_docs(docs, 96)
    return docs, {m: J.materialize(ctx, k=4, mode="approx", num_perm=32,
                                   method=m) for m in METHODS}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SHARDS)
def test_materialize_approx_and_signatures_match_reference(approx_ref, n,
                                                           kind):
    docs, want = approx_ref
    ctx = _meshed(docs, 96, n, kind)
    for m in METHODS:
        net = T.materialize(ctx, k=4, mode="approx", num_perm=32, method=m)
        _same(net, want[m], f"{n}/{kind}/{m}")
        assert tuple(net.stats) == tuple(want[m].stats)
        assert net.recall_estimate == float(want[m].recall_estimate)
    j_sig = J.QueryContext.from_docs(docs, 96).term_signatures(num_perm=32)
    np.testing.assert_array_equal(
        T.to_uint32(ctx.term_signatures(num_perm=32)), np.asarray(j_sig))
    a, b = T.hash_coefficients(32)
    np.testing.assert_array_equal(
        T.to_uint32(T.sharded_signatures(ctx.index.packed, a, b,
                                         _mesh(n, kind), perm_tile=5)),
        np.asarray(j_sig))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SHARDS)
def test_cooccur_counts_sharded_matches_reference(n, kind):
    rng = np.random.default_rng(n)
    d, vl, vr = 100, 7, 29
    xl = (rng.random((d, vl)) < 0.3).astype(np.int8)
    xr = (rng.random((d, vr)) < 0.3).astype(np.int8)
    want = np.asarray(j_ops.cooccur_counts(
        jnp.asarray(xl, jnp.bfloat16), jnp.asarray(xr, jnp.bfloat16),
        backend="interpret"))
    # the port's operands: .t() views of term-major storage
    tl = torch.from_numpy(np.ascontiguousarray(xl.T)).t()
    tr = torch.from_numpy(np.ascontiguousarray(xr.T)).t()
    got = ops.cooccur_counts_sharded(tl, tr, mesh=_mesh(n, kind))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


def test_sharded_counts_and_block_topk_match_one_device():
    idx = T.pack_docs(DOCS, V, device="cpu")
    x = T.dense_operand(idx)
    masks = idx.packed.T[:6].contiguous()
    rows = torch.arange(6)
    want = T.doc_freq_under_batch(idx, masks)
    blocked = T.chunked_top_k(torch.where(
        torch.arange(V)[None, :] == rows[:, None], -1, want), 40)
    for n in (3, 8):
        for kind in KINDS:
            mesh = _mesh(n, kind)
            for m in METHODS:
                got = T.sharded_counts(idx, masks, m, {"x_dense": x}, mesh)
                assert torch.equal(got, want), (n, kind, m)
                w, i = T.sharded_block_topk(idx, masks, rows, {"x_dense": x},
                                            k=40, method=m, mesh=mesh)
                assert torch.equal(w, blocked[0]) and torch.equal(
                    i, blocked[1]), (n, kind, m)


# ---------------------------------------------------------------------------
# state under a mesh: ingest, eviction, restore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_ingest_and_eviction_under_a_mesh(kind):
    """A windowed meshed context in lockstep with the reference's
    single-device one: the shard artifact rebuilds once per epoch and
    never between two ingests."""
    docs = _docs(V, 60, 7)
    t_ctx = T.QueryContext.from_docs([], V, device="cpu", window=40,
                                     mesh=_mesh(3, kind))
    j_ctx = J.QueryContext.from_docs([], V, window=40)
    seeds = SEEDS[:2]
    for lo in range(0, 60, 20):
        for ctx in (t_ctx, j_ctx):
            ctx.ingest_docs(docs[lo:lo + 20])
        shards = t_ctx.mesh_shards()
        assert t_ctx.mesh_shards() is shards
        for m in ("fused",):
            _same(T.bfs_construct_batch(t_ctx, torch.from_numpy(seeds),
                                        method=m, **PLAN),
                  J.bfs_construct_batch(j_ctx, jnp.asarray(seeds), method=m,
                                        **PLAN), f"{lo}/{m}")
        assert t_ctx.mesh_shards() is shards
    assert t_ctx.evicted_docs_total == j_ctx.evicted_docs_total > 0
    _same(T.materialize(t_ctx, k=4, method="pallas"),
          J.materialize(j_ctx, k=4, method="pallas"))
    t_ctx.retire_oldest_block()
    j_ctx.retire_oldest_block()
    assert t_ctx.mesh_shards() is not shards
    _same(T.materialize(t_ctx, k=4, method="gemm", shard_strategy="cols"),
          J.materialize(j_ctx, k=4, method="gemm"))


@pytest.mark.parametrize("kind", KINDS)
def test_load_context_of_a_reference_snapshot_onto_a_mesh(tmp_path, kind):
    """One reference snapshot restores onto a port mesh and answers as the
    reference's single-device context (``TestMeshedRestore``)."""
    j_ctx = J.QueryContext.from_docs([], V, capacity=64, window=40)
    docs = _docs(V, 60, 9)
    j_ctx.ingest_docs(docs[:30], scope="a")
    j_ctx.ingest_docs(docs[30:], scope="b")
    J.save_context(j_ctx, str(tmp_path / "snap"))
    meshed = T.load_context(str(tmp_path / "snap"), device="cpu",
                            mesh=_mesh(4, kind))
    assert meshed.mesh == _mesh(4, kind)
    seeds = SEEDS[:2]
    for scope in (None, "b"):
        mask = None if scope is None else meshed.scope(scope)
        j_mask = None if scope is None else j_ctx.scope(scope)
        for m in ("popcount", "fused"):
            _same(T.bfs_construct_batch(meshed, torch.from_numpy(seeds),
                                        method=m, scope_mask=mask, **PLAN),
                  J.bfs_construct_batch(j_ctx, jnp.asarray(seeds), method=m,
                                        scope_mask=j_mask, **PLAN))
    _same(T.materialize(meshed, k=4, method="pallas", scope="b"),
          J.materialize(j_ctx, k=4, method="pallas", scope="b"))


def test_cooc_index_and_server_on_a_mesh(tmp_path):
    from repro.api import CoocIndex as JIndex
    from repro_torch.api import CoocIndex
    texts = [" ".join(f"w{t}" for t in d) for d in DOCS]
    j_idx = JIndex.from_texts(texts, depth=2, topk=4, beam=8)
    idx = CoocIndex.from_texts(texts, device="cpu", depth=2, topk=4, beam=8,
                               devices=["cpu"] * 3)
    assert idx.mesh == T.make_cooc_mesh(devices=["cpu"] * 3)
    for m in METHODS:
        assert idx.network(["w3"], method=m) == j_idx.network(["w3"],
                                                                method=m)
        assert idx.full_network(k=4, method=m) == j_idx.full_network(
            k=4, method=m)
    idx.save(str(tmp_path / "snap"))
    docs_mesh = T.make_cooc_mesh(devices=["cpu"] * 2, shard="docs")
    loaded = CoocIndex.load(str(tmp_path / "snap"), device="cpu",
                            mesh=docs_mesh)
    assert loaded.mesh == docs_mesh
    assert loaded.full_network(k=4) == j_idx.full_network(k=4)
    from repro_torch.serve import CoocServer
    srv = CoocServer.from_snapshot(str(tmp_path / "snap"), device="cpu",
                                   mesh=docs_mesh)
    assert srv.ctx.mesh == docs_mesh


# ---------------------------------------------------------------------------
# the reference on 8 forced devices, directly
# ---------------------------------------------------------------------------

_REF_MESHED = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.core import QueryContext, bfs_construct_batch, materialize
    from repro.core import make_cooc_mesh
    assert len(jax.devices()) == 8
    docs = [list(d) for d in {docs!r}]
    seeds = jnp.asarray(np.asarray({seeds!r}, np.int32))
    out = {{}}
    for shard in ("terms", "docs"):
        ctx = QueryContext.from_docs(docs, {v}, mesh=make_cooc_mesh(
            shard=shard))
        for m in {methods!r}:
            net = bfs_construct_batch(ctx, seeds, method=m, **{plan!r})
            out[f"bfs/{{shard}}/{{m}}"] = net
            out[f"net/{{shard}}/{{m}}"] = materialize(ctx, k=4, method=m)
        out[f"cols/{{shard}}"] = materialize(ctx, k=4, method="pallas",
                                             shard_strategy="cols")
    arrays = {{f"{{k}}/{{f}}": np.asarray(getattr(v, f))
              for k, v in out.items()
              for f in ("src", "dst", "weight", "valid")}}
    np.savez(sys.argv[1], **arrays)
    print("REF-MESHED-OK", len(out))
""")


def test_reference_meshed_on_8_devices_equals_the_port_8_shards(tmp_path):
    script = _REF_MESHED.format(docs=DOCS, seeds=SEEDS.tolist(), v=V,
                                methods=METHODS, plan=PLAN)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH"))
               if p)}
    out = tmp_path / "ref.npz"
    r = subprocess.run([sys.executable, "-c", script, str(out)], env=env,
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "REF-MESHED-OK" in r.stdout
    want = np.load(out)
    for shard in KINDS:
        ctx = _meshed(DOCS, V, 8, shard)
        got = {}
        for m in METHODS:
            got[f"bfs/{shard}/{m}"] = T.bfs_construct_batch(
                ctx, torch.from_numpy(SEEDS), method=m, **PLAN)
            got[f"net/{shard}/{m}"] = T.materialize(ctx, k=4, method=m)
        got[f"cols/{shard}"] = T.materialize(ctx, k=4, method="pallas",
                                             shard_strategy="cols")
        for key, net in got.items():
            for i, f in enumerate(("src", "dst", "weight", "valid")):
                np.testing.assert_array_equal(
                    _slots(net)[i], want[f"{key}/{f}"].astype(np.int64),
                    err_msg=key)
