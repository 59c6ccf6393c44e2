"""The port's GIN, neighbour sampler and synthetic graph against the JAX
reference's, on the CPU.

GIN's parameters come from the reference's ``init_gin`` (as numpy) at
gin-tu's published widths (5 layers, d 64; the reference's
``reduced_config`` keeps gin-tu as it is) and are carried across by
``params_from_reference``; graphs come from both packages'
``gnn_synthetic_graph``.  fp32 tolerance: rtol = atol = 1e-5 (the same
arithmetic, the sums taken in another order).  The sampler, the subgraph
sizes and the synthetic graph are compared bit for bit; accuracies, which
count integer hits, exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import replace as jax_replace  # noqa: E402
from repro.data import (build_csr as j_build_csr,  # noqa: E402
                        gnn_synthetic_graph as j_graph,
                        sample_subgraph as j_sample,
                        subgraph_sizes as j_sizes)
from repro.launch.train import reduced_config  # noqa: E402
from repro.models import gnn as JG  # noqa: E402
from repro_torch.configs import GNNConfig, get_config, replace  # noqa: E402
from repro_torch.data import (build_csr, gnn_synthetic_graph,  # noqa: E402
                              sample_subgraph, subgraph_sizes)
from repro_torch.models import gnn as G  # noqa: E402

RTOL = ATOL = 1e-5
D_FEAT, N_CLASSES = 32, 8


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module", params=[True, False],
                ids=["learnable_eps", "fixed_eps"])
def reference(request):
    """gin-tu (reduced_config is the config itself), and the same with
    ``learnable_eps=False``; eps set to 0.25 per layer times its index so
    that it enters the arithmetic."""
    jcfg = reduced_config(jax_config("gin-tu"))
    assert jcfg == jax_config("gin-tu")
    jcfg = jax_replace(jcfg, learnable_eps=request.param)
    cfg = replace(get_config("gin-tu"), learnable_eps=request.param)
    params = JG.init_gin(jcfg, jax.random.PRNGKey(0), D_FEAT, N_CLASSES)
    for i, lp in enumerate(params["layers"]):
        lp["eps"] = jnp.float32(0.25 * i)
    model = G.params_from_reference(cfg, _np_tree(params), device="cpu")
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def graph():
    g = gnn_synthetic_graph(300, 1500, D_FEAT, N_CLASSES, seed=4)
    g["label_mask"] = (np.arange(300) % 3 != 0).astype(np.float32)
    return g


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# data: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,e,d,c,seed,power", [
    (200, 2000, 8, 4, 0, 1.0), (513, 4096, 17, 7, 3, 0.7),
    (30, 64, 16, 2, 11, 1.0)])
def test_gnn_synthetic_graph_is_the_references_bit_for_bit(n, e, d, c, seed,
                                                          power):
    got = gnn_synthetic_graph(n, e, d, c, seed=seed, power=power)
    want = j_graph(n, e, d, c, seed=seed, power=power)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_build_csr_is_the_references_bit_for_bit():
    g = j_graph(150, 1200, 4, 3, seed=1)
    got = build_csr(g["edge_src"], g["edge_dst"], 150)
    want = j_build_csr(g["edge_src"], g["edge_dst"], 150)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fanouts,n_seeds,seed", [
    ((3, 2), 8, 0), ((4,), 5, 1), ((15, 10), 16, 2), ((2, 2, 2), 3, 3)])
def test_sample_subgraph_is_the_references_bit_for_bit(fanouts, n_seeds,
                                                       seed):
    """Two draws in a row from one generator each (the generator's state
    after the first matters too); a graph with isolated nodes, so some
    frontier nodes have no in-edges."""
    g = j_graph(400, 900, 4, 3, seed=seed)
    indptr, indices = j_build_csr(g["edge_src"], g["edge_dst"], 400)
    seeds = np.random.default_rng(seed).choice(400, n_seeds, replace=False)
    r1, r2 = np.random.default_rng(seed + 10), np.random.default_rng(seed + 10)
    for _ in range(2):
        got = sample_subgraph(indptr, indices, seeds, fanouts, r1)
        want = j_sample(indptr, indices, seeds, fanouts, r2)
        assert sorted(got) == sorted(want)
        for k in want:
            if k == "n_seeds":
                assert got[k] == want[k] == n_seeds
                continue
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["nodes"].shape == (subgraph_sizes(n_seeds, fanouts)[0],)
    assert int(np.diff(indptr).min()) == 0


@pytest.mark.parametrize("b,fanouts", [(1024, (15, 10)), (8, (3, 2)),
                                       (5, ()), (7, (1, 1, 1))])
def test_subgraph_sizes_are_the_references(b, fanouts):
    assert subgraph_sizes(b, fanouts) == j_sizes(b, fanouts)
    if fanouts == (15, 10):
        assert subgraph_sizes(b, fanouts) == (169_984, 168_960)


def test_gnn_config_is_the_references():
    cfg, want = get_config("gin-tu"), jax_config("gin-tu")
    assert isinstance(cfg, GNNConfig)
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__ if
            f != "shapes"} == {f: getattr(want, f) for f in
                               want.__dataclass_fields__ if f != "shapes"}
    assert [(s.name, s.kind, s.dims) for s in cfg.shapes] == [
        (s.name, s.kind, s.dims) for s in want.shapes]


# ---------------------------------------------------------------------------
# GIN
# ---------------------------------------------------------------------------


def test_params_from_reference_carry_every_weight(reference):
    jcfg, params, cfg, model = reference
    assert len(model.layers) == 5
    for lp, want in zip(model.layers, params["layers"]):
        for k, v in want.items():
            got = getattr(lp, k)
            assert got.dtype == (torch.float32)
            np.testing.assert_array_equal(got.numpy(), np.asarray(v))
    np.testing.assert_array_equal(model.out.numpy(), np.asarray(params["out"]))
    assert model.layers[0].w1.shape == (D_FEAT, 64)
    assert model.out.shape == (64, N_CLASSES)
    assert model.layers[2].eps.shape == () and float(model.layers[2].eps) == 0.5


@pytest.mark.parametrize("masked", [False, True])
def test_gin_forward_and_node_logits_match_reference(reference, graph,
                                                     masked):
    jcfg, params, cfg, model = reference
    batch = dict(graph)
    if masked:
        batch["edge_mask"] = (np.arange(1500) % 4 != 1).astype(np.float32)
    jb, tb = _both(batch)
    want = JG.gin_forward(jcfg, params, jb["x"], jb["edge_src"],
                          jb["edge_dst"], jb.get("edge_mask"))
    got = G.gin_forward(cfg, model, tb["x"], tb["edge_src"], tb["edge_dst"],
                        tb.get("edge_mask"))
    assert got.shape == (300, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(
        G.node_logits(cfg, model, got).numpy(),
        np.asarray(JG.node_logits(jcfg, params, want)), rtol=RTOL, atol=ATOL)


def test_edge_mask_equals_dropping_the_masked_edges(reference, graph):
    _, _, cfg, model = reference
    _, tb = _both(graph)
    keep = torch.from_numpy(np.arange(1500) % 5 != 2)
    masked = G.gin_forward(cfg, model, tb["x"], tb["edge_src"],
                           tb["edge_dst"], keep.float())
    dropped = G.gin_forward(cfg, model, tb["x"], tb["edge_src"][keep],
                            tb["edge_dst"][keep])
    torch.testing.assert_close(masked, dropped, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_node_loss_matches_reference(reference, graph, masked):
    jcfg, params, cfg, model = reference
    batch = dict(graph)
    if masked:
        batch["edge_mask"] = (np.arange(1500) % 3 == 0).astype(np.float32)
    jb, tb = _both(batch)
    want, wm = JG.node_loss(jcfg, params, jb)
    got, gm = G.node_loss(cfg, model, tb)
    assert sorted(gm) == sorted(wm) == ["acc", "loss"]
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)
    assert float(gm["acc"]) == float(wm["acc"])


def _molecules(n_g=6, n_n=10, n_e=20, d=D_FEAT, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((n_g * n_n, d)).astype(np.float32),
        "edge_src": np.concatenate([rng.integers(0, n_n, n_e) + i * n_n
                                    for i in range(n_g)]).astype(np.int32),
        "edge_dst": np.concatenate([rng.integers(0, n_n, n_e) + i * n_n
                                    for i in range(n_g)]).astype(np.int32),
        "graph_id": np.repeat(np.arange(n_g), n_n).astype(np.int32),
        "labels": rng.integers(0, N_CLASSES, n_g).astype(np.int32),
    }


def test_graph_logits_and_graph_loss_match_reference(reference):
    jcfg, params, cfg, model = reference
    jb, tb = _both(_molecules())
    h = G.gin_forward(cfg, model, tb["x"], tb["edge_src"], tb["edge_dst"])
    jh = JG.gin_forward(jcfg, params, jb["x"], jb["edge_src"], jb["edge_dst"])
    np.testing.assert_allclose(
        G.graph_logits(cfg, model, h, tb["graph_id"], 6).numpy(),
        np.asarray(JG.graph_logits(jcfg, params, jh, jb["graph_id"], 6)),
        rtol=RTOL, atol=ATOL)
    want, wm = JG.graph_loss(jcfg, params, jb)
    got, gm = G.graph_loss(cfg, model, tb)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)
    assert float(gm["acc"]) == float(wm["acc"])


def test_accuracy_takes_the_first_maximum_as_jnp_argmax():
    """Rows with tied maxima: the first one is the prediction."""
    logits = torch.tensor([[1.0, 3.0, 3.0], [2.0, 2.0, 2.0], [0.0, -1.0, 0.0],
                           [-5.0, 4.0, 4.0]])
    want = np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1))
    assert G._first_argmax(logits).tolist() == want.tolist() == [1, 0, 0, 1]


def test_layer_norm_is_the_population_variance():
    x = np.random.default_rng(9).standard_normal((40, 64)).astype(np.float32)
    g = np.linspace(0.5, 1.5, 64).astype(np.float32)
    want = np.asarray(JG._layer_norm(jnp.asarray(x), jnp.asarray(g)))
    got = G._layer_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    xf = x.astype(np.float64)
    unbiased = (xf - xf.mean(-1, keepdims=True)) / np.sqrt(
        xf.var(-1, ddof=1, keepdims=True) + 1e-5) * g
    assert np.abs(got - unbiased).max() > 1e-3


def test_aggregate_is_the_neighbour_sum():
    """One GIN aggregation == the adjacency sum, exactly on small ints."""
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    src, dst = torch.tensor([0, 1, 3, 3]), torch.tensor([2, 2, 0, 2])
    agg = G._aggregate(x, src, dst)
    assert agg.tolist() == [x[3].tolist(), [0.0] * 3, (x[0] + x[1] + x[3]
                                                       ).tolist(), [0.0] * 3]
    masked = G._aggregate(x, src, dst, torch.tensor([1.0, 0.0, 1.0, 1.0]))
    assert masked[2].tolist() == (x[0] + x[3]).tolist()


def test_init_gin_draws_from_the_generator():
    cfg = get_config("gin-tu")
    a = G.init_gin(cfg, torch.Generator().manual_seed(0), 100, 47,
                   device="cpu")
    b = G.init_gin(cfg, torch.Generator().manual_seed(0), 100, 47,
                   device="cpu")
    c = G.init_gin(cfg, torch.Generator().manual_seed(1), 100, 47,
                   device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert not torch.equal(a.layers[0].w1, c.layers[0].w1)
    ref = JG.init_gin(jax_config("gin-tu"), jax.random.PRNGKey(0), 100, 47)
    for name, p in a.named_parameters():
        if name.endswith(("b1", "b2", "out_b", "eps")):
            assert bool((p == 0).all()), name
        elif name.endswith("ln"):
            assert bool((p == 1).all()), name
        else:
            assert abs(float(p.std()) * np.sqrt(p.shape[0]) - 1.0) < 0.1, name
    want = {f"layers.{i}.{k}": np.shape(v)
            for i, lp in enumerate(ref["layers"]) for k, v in lp.items()}
    want.update(out=np.shape(ref["out"]), out_b=np.shape(ref["out_b"]))
    assert {n: tuple(p.shape) for n, p in a.named_parameters()} == want
    assert a.layers[0].eps.dtype == torch.float32


def test_gin_refuses_the_cpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        G.init_gin(get_config("gin-tu"), torch.Generator(), 8, 2)
