"""The public surface of ``repro_torch.core`` (and of the port's configs,
data, kernel wrappers, LM models and serving) against the reference's,
and the host-side references of ``repro.core``.

Output parity tests elsewhere compare what the port computes; these
compare what it offers: every name ``repro.core`` exports, every keyword
parameter of a shared function or class (except the documented
departures), the configs field for field, and the surface faults found by
a ``dir()`` / ``inspect.signature`` diff of the two packages, each with
the probe that showed it.  Exact equality throughout.
"""
import dataclasses
import importlib
import inspect
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.core as J  # noqa: E402
import repro.data as JD  # noqa: E402
import repro.kernels.ops as JO  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.data as TD  # noqa: E402
from repro.api import CoocIndex as JIndex  # noqa: E402
from repro_torch.api import CoocIndex  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: keyword parameters the port renames on purpose (ROADMAP.md §3,
#: "Deliberate departures"): the reference's dense dtype is the port's
#: device (its x_dense is int8 whatever the dtype)
DEPARTURES = {"dtype": "device"}

#: names of the reference's data, configs and kernel-wrapper modules the
#: port lacks because they serve the side models (ROADMAP.md §1): none
#: since the side models were ported
SIDE_MODELS = {
    "configs": set(),
    "data": set(),
    "ops": set(),
}
#: the LM path's departures (ROADMAP.md §3): an ``nn.Module`` for the
#: params pytree, a ``torch.Generator`` for the key
LM_DEPARTURES = {"params": "model", "key": "generator"}
#: the sharding specs of ``repro.models.transformer``, ported with the
#: launch layer
LM_SPECS = {"param_specs", "cache_specs"}
#: the private functions of the LM path the port keeps under their names
LM_PRIVATE = {"layers": {"_attend"}, "moe": {"_position_in_expert"},
              "transformer": {"_decode_attn"}}
#: the sharding specs of ``repro.models.recsys`` and ``repro.models.gnn``,
#: ported with the launch layer, and the private functions the port keeps
#: under their names
SIDE_SPECS = {"param_specs"}
SIDE_PRIVATE = {"recsys": {"_flat_field_ids", "_seq_encode"},
                "gnn": {"_layer_norm"}}
#: the reference's Pallas and XLA backends and its module imports: the
#: port's wrappers pick the CUDA kernel or its plain version by device
BACKENDS = {"cooccur_gemm_pallas", "dot_interaction_pallas",
            "flash_decode_pallas", "flash_decode_xla", "level_step_pallas",
            "level_step_topk_xla", "pallas_backend", "postings_counts_pallas",
            "functools", "jax", "jnp"}

DOCS = [[0, 1], [1, 2], [0, 2, 3]]


def _public(module):
    return {n for n in dir(module) if not n.startswith("_")}


def _params(obj):
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return [p.name for p in sig.parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _slots(net):
    return np.stack([np.asarray(getattr(net, f)).astype(np.int64)
                     for f in ("src", "dst", "weight", "valid")])


# ---------------------------------------------------------------------------
# surfaces
# ---------------------------------------------------------------------------


def test_every_name_of_repro_core_is_in_the_port():
    assert _public(J) - _public(T) == set()


def test_keyword_parameters_of_shared_names_match():
    """Every parameter of a function or class ``repro.core`` exports, and
    of the public methods of its classes, exists in the port under the
    same name, but for :data:`DEPARTURES`."""
    missing = []
    for name in sorted(_public(J)):
        ref, port = getattr(J, name), getattr(T, name)
        if inspect.ismodule(ref):
            continue
        pairs = [(name, ref, port)]
        if inspect.isclass(ref):
            pairs += [(f"{name}.{m}", getattr(ref, m), getattr(port, m, None))
                      for m, v in vars(ref).items()
                      if (not m.startswith("_") or m == "__init__")
                      and (callable(v) or isinstance(v, classmethod))]
        for label, r, p in pairs:
            if p is None:
                missing.append((label, "absent"))
                continue
            pr, pp = _params(r), _params(p)
            if pr is None or pp is None:
                continue
            gone = [a for a in pr if a not in pp
                    and DEPARTURES.get(a) not in pp]
            if gone:
                missing.append((label, gone))
    assert missing == []


def test_the_other_gaps_are_the_side_models_as_roadmap_lists_them():
    gaps = {"configs": _public(JC) - _public(TC),
            "data": _public(JD) - _public(TD),
            "ops": _public(JO) - _public(ops)}
    assert gaps["configs"] == SIDE_MODELS["configs"]
    assert gaps["data"] == SIDE_MODELS["data"]
    assert gaps["ops"] - BACKENDS == SIDE_MODELS["ops"]
    assert {"BaseConfig", "CoocConfig"} <= _public(TC)
    assert "cooccur_counts_sharded" in _public(ops)
    roadmap = (ROOT / "ROADMAP.md").read_text()
    names = sorted(set().union(*SIDE_MODELS.values()))
    if not names:
        # no gap left: the roadmap's queue of modules to port says so
        assert "**Still to port: none.**" in roadmap
        return
    item = roadmap[roadmap.index("**The seed's side models.**"):]
    item = item[:item.index("### 2.")]
    for name in names:
        assert re.search(rf"\b{name}\b", item), name


def _own_functions(module):
    return {n for n, v in vars(module).items() if inspect.isfunction(v)
            and v.__module__ == module.__name__}


@pytest.mark.parametrize("name", ["layers", "moe", "transformer"])
def test_lm_model_surfaces_match(name):
    """Every public function of ``repro.models.<name>`` (the sharding
    specs :data:`LM_SPECS` included), and the private ones the port keeps,
    exists in the port with every keyword parameter, up to
    :data:`LM_DEPARTURES`."""
    ref = importlib.import_module(f"repro.models.{name}")
    port = importlib.import_module(f"repro_torch.models.{name}")
    names = {n for n in _own_functions(ref) if not n.startswith("_")}
    names |= LM_PRIVATE[name]
    assert names - _own_functions(port) == set()
    wrong = {}
    for n in sorted(names):
        pp = _params(getattr(port, n))
        gone = [a for a in _params(getattr(ref, n))
                if a not in pp and LM_DEPARTURES.get(a) not in pp]
        if gone:
            wrong[n] = gone
    assert wrong == {}
    if name == "transformer":
        assert LM_SPECS <= _own_functions(ref) & _own_functions(port)


@pytest.mark.parametrize("name", ["recsys", "gnn"])
def test_side_model_surfaces_match(name):
    """Every public function of ``repro.models.<name>`` (the sharding
    specs :data:`SIDE_SPECS` included), and the private ones the port
    keeps, exists in the port with every keyword parameter, up to
    :data:`LM_DEPARTURES` (an ``nn.Module`` for the params pytree, a
    ``torch.Generator`` for the key)."""
    ref = importlib.import_module(f"repro.models.{name}")
    port = importlib.import_module(f"repro_torch.models.{name}")
    names = {n for n in _own_functions(ref) if not n.startswith("_")}
    assert SIDE_SPECS <= names
    names |= SIDE_PRIVATE[name]
    assert names - _own_functions(port) == set()
    assert SIDE_SPECS <= _own_functions(port)
    wrong = {}
    for n in sorted(names):
        pp = _params(getattr(port, n))
        gone = [a for a in _params(getattr(ref, n))
                if a not in pp and LM_DEPARTURES.get(a) not in pp]
        if gone:
            wrong[n] = gone
    assert wrong == {}


#: the training slice's departures (ROADMAP.md §3): an ``nn.Module`` for
#: the params pytree and a ``torch.Generator`` for the key, as above; the
#: optimizers' ``state_specs`` and ``restore(shardings=)`` came with the
#: launch layer, so every parameter is checked
TRAIN_DEPARTURES = dict(LM_DEPARTURES)
TRAIN_PORTED = {"Optimizer": {"state_specs"}, "restore": {"shardings"}}
#: the reference's private helpers whose work the port does elsewhere: the
#: flatten by ``jax.tree_util`` (``repro_torch.pytree``)
TRAIN_PRIVATE_GONE = {"_flatten"}
TRAIN_MODULES = ["train", "train.optimizer", "train.step", "train.checkpoint",
                 "train.compression", "train.elastic", "train.straggler",
                 "launch.train"]


def _own_names(module):
    """Functions and classes defined in ``module``, and for a package the
    names it exports."""
    own = {n for n, v in vars(module).items()
           if (inspect.isfunction(v) or inspect.isclass(v))
           and (v.__module__ == module.__name__ or hasattr(module,
                                                           "__path__"))}
    if hasattr(module, "__path__"):
        own |= {n for n, v in vars(module).items() if inspect.ismodule(v)
                and v.__name__.startswith(module.__name__ + ".")}
    return own


@pytest.mark.parametrize("name", TRAIN_MODULES)
def test_training_surfaces_match(name):
    """``repro.<name>`` against ``repro_torch.<name>``: every function,
    class and (for the package) export is in the port, every keyword
    parameter of each (a NamedTuple's fields, a class's ``__init__`` and
    public methods) too, up to :data:`TRAIN_DEPARTURES` and
    with :data:`TRAIN_PORTED`'s among them."""
    ref = importlib.import_module(f"repro.{name}")
    port = importlib.import_module(f"repro_torch.{name}")
    names = _own_names(ref) - TRAIN_PRIVATE_GONE
    assert names - _own_names(port) == set()
    wrong = {}
    for n in sorted(names):
        r, p = getattr(ref, n), getattr(port, n)
        if inspect.ismodule(r):
            continue
        pairs = [(n, r, p)]
        if inspect.isclass(r):
            pairs += [(f"{n}.{m}", getattr(r, m), getattr(p, m, None))
                      for m, v in vars(r).items()
                      if not m.startswith("_") and callable(v)]
        for label, rr, pp in pairs:
            if pp is None:
                wrong[label] = "absent"
                continue
            pr, pq = _params(rr), _params(pp)
            if pr is None or pq is None:
                continue
            gone = [a for a in pr if a not in pq
                    and TRAIN_DEPARTURES.get(a) not in pq]
            if gone:
                wrong[label] = gone
    assert wrong == {}
    for label, ported in TRAIN_PORTED.items():
        if hasattr(port, label):
            assert ported <= set(_params(getattr(port, label)))


def test_serve_surface_matches():
    """``repro.serve``'s names are all in the port's; ``DecodeServer`` and
    ``Request`` keep the reference's parameters and fields."""
    import repro.serve as JS
    import repro_torch.serve as TS
    assert _public(JS) - _public(TS) == set()
    for m in ("__init__", "submit", "step", "run_until_drained"):
        pp = _params(getattr(TS.DecodeServer, m))
        assert [a for a in _params(getattr(JS.DecodeServer, m))
                if a not in pp and LM_DEPARTURES.get(a) not in pp] == [], m
    assert [(f.name, f.default) for f in dataclasses.fields(TS.Request)] == [
        (f.name, f.default) for f in dataclasses.fields(JS.Request)]


# ---------------------------------------------------------------------------
# the four surface faults and the fused counts, each with its probe
# ---------------------------------------------------------------------------


def test_query_context_mesh_probe():
    """Fault 1: the reference's ``QueryContext.mesh``."""
    j_ctx = J.QueryContext.from_docs([[0, 1], [1, 2]], 4)
    ctx = T.QueryContext.from_docs([[0, 1], [1, 2]], 4, device="cpu")
    assert ctx.mesh is None and j_ctx.mesh is None
    mesh = T.make_cooc_mesh(devices=["cpu"] * 2)
    assert T.QueryContext.from_docs([[0, 1]], 4, device="cpu",
                                    mesh=mesh).mesh == mesh
    idx = CoocIndex(device="cpu", devices=["cpu"] * 2)
    assert idx.mesh == mesh and idx.mesh is idx.ctx.mesh
    assert CoocIndex(device="cpu").mesh is None is JIndex().mesh


def test_materialize_col_tile_probe():
    """Fault 2: ``materialize(col_tile=)`` changes no result and keys the
    cache as the reference's does."""
    j_ctx = J.QueryContext.from_docs(DOCS, 4)
    ctx = T.QueryContext.from_docs(DOCS, 4, device="cpu")
    want = J.materialize(j_ctx, k=2, col_tile=128)
    assert np.asarray(want.weight).tolist() == [1] * 8
    for method in ("gemm", "pallas"):
        net = T.materialize(ctx, k=2, col_tile=128, method=method)
        np.testing.assert_array_equal(
            _slots(net), _slots(J.materialize(j_ctx, k=2, col_tile=128,
                                              method=method)))
        # keyed by the tile clamped to the vocabulary's 128 columns
        assert T.materialize(ctx, k=2, col_tile=256, method=method) is net
        assert T.materialize(ctx, k=2, col_tile=64, method=method) is not net
    with pytest.raises(ValueError, match="col_tile"):
        T.materialize(ctx, k=2, col_tile=0, method="pallas")
    with pytest.raises(ZeroDivisionError):
        J.materialize(j_ctx, k=2, col_tile=0, method="pallas")


def test_block_signatures_perm_tile_probe():
    """Fault 2: ``block_signatures(perm_tile=)`` tiles the permutations
    and changes no result; a tile below 1 is clamped to 1 as the
    reference clamps it."""
    idx = T.pack_docs(DOCS, 4, device="cpu")
    a, b = T.hash_coefficients(20, 3)
    want = np.asarray(J.block_signatures(
        J.pack_docs(DOCS, 4).packed, [0, 2], a, b, perm_tile=7))
    for tile in (7, 16, 0, 64):
        np.testing.assert_array_equal(
            T.to_uint32(T.block_signatures(idx.packed, [0, 2], a, b,
                                           perm_tile=tile)), want)
        np.testing.assert_array_equal(
            T.to_uint32(T.minhash_signatures(idx.packed, a, b,
                                             perm_tile=tile)),
            np.asarray(J.minhash_signatures(J.pack_docs(DOCS, 4).packed,
                                            jnp.asarray(a), jnp.asarray(b))))


def test_x_dense_legacy_spelling_probe():
    """Fault 3: ``bfs_construct(x_dense=)``, the port's int8 operand."""
    j_ctx = J.QueryContext.from_docs(DOCS, 4)
    ctx = T.QueryContext.from_docs(DOCS, 4, device="cpu")
    want = J.bfs_construct(j_ctx.index, jnp.asarray([0], jnp.int32),
                           depth=1, topk=2, beam=2, method="gemm",
                           x_dense=j_ctx.x_dense())
    assert np.asarray(want.weight).tolist() == [1, 1, 0, 0]
    got = T.bfs_construct(ctx.index, torch.tensor([0]), depth=1, topk=2,
                          beam=2, method="gemm", x_dense=ctx.x_dense())
    np.testing.assert_array_equal(_slots(got), _slots(want))
    batch = T.bfs_construct_batch(ctx.index, torch.tensor([[0], [2]]),
                                  depth=1, topk=2, beam=2, method="gemm",
                                  x_dense=ctx.x_dense())
    np.testing.assert_array_equal(
        _slots(batch), _slots(J.bfs_construct_batch(
            j_ctx.index, jnp.asarray([[0], [2]], jnp.int32), depth=1,
            topk=2, beam=2, method="gemm", x_dense=j_ctx.x_dense())))
    x = ctx.x_dense()
    for bad in (x.to(torch.bfloat16), x.contiguous(), x[:, :2]):
        with pytest.raises(ValueError, match="int8"):
            T.bfs_construct(ctx.index, torch.tensor([0]), depth=1, topk=2,
                            beam=2, method="gemm", x_dense=bad)


def test_cooccur_csl_config_is_a_base_config_probe():
    """Fault 4: ``cooccur-csl`` is a ``BaseConfig`` with its family and
    shapes; it and ``dlrm-rm2`` equal the reference's field for field."""
    for arch in ("cooccur-csl", "dlrm-rm2"):
        cfg, jcfg = TC.get_config(arch), JC.get_config(arch)
        assert isinstance(cfg, TC.BaseConfig)
        assert [f.name for f in dataclasses.fields(cfg)] == [
            f.name for f in dataclasses.fields(jcfg)]
        for f in dataclasses.fields(jcfg):
            got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
            if f.name == "shapes":
                got = [(s.name, s.kind, s.dims) for s in got]
                want = [(s.name, s.kind, s.dims) for s in want]
            assert got == want, (arch, f.name)
    cfg = TC.get_config("cooccur-csl")
    assert isinstance(cfg, TC.CoocConfig) and cfg.family == "cooccur"
    assert [s.name for s in cfg.shapes] == ["build_full", "query_bfs_d3",
                                            "query_batch", "stream_ingest"]
    assert cfg.shape("query_batch")["n_queries"] == 256
    assert cfg.n_words == JC.get_config("cooccur-csl").n_words == 12382
    with pytest.raises(KeyError, match="unknown shape"):
        cfg.shape("nope")
    assert [f.name for f in dataclasses.fields(TC.BaseConfig)] == [
        f.name for f in dataclasses.fields(JC.BaseConfig)]


def test_fused_counts_go_through_the_postings_wrapper(monkeypatch):
    """Repair 5: "fused"'s counts-only form (materialization, a doc
    mesh's shards) is the postings kernel's wrapper, so a CUDA tensor
    launches kernel 1; "popcount" stays the plain version everywhere."""
    calls = []
    real = ops.postings_counts

    def spy(masks, packed):
        calls.append(masks.shape)
        return real(masks, packed)

    monkeypatch.setattr(ops, "postings_counts", spy)
    ctx = T.QueryContext.from_docs(DOCS, 4, device="cpu")
    j_ctx = J.QueryContext.from_docs(DOCS, 4)
    net = T.materialize(ctx, k=2, method="fused")
    assert calls, "fused counts never reached ops.postings_counts"
    np.testing.assert_array_equal(
        _slots(net), _slots(J.materialize(j_ctx, k=2, method="fused")))
    calls.clear()
    T.materialize(ctx, k=2, method="popcount")
    assert calls == []


# ---------------------------------------------------------------------------
# host references, corpus statistics, the registry view
# ---------------------------------------------------------------------------


def test_host_references_match():
    rng = np.random.default_rng(5)
    corpus = [rng.integers(0, 12, rng.integers(1, 6)).tolist()
              for _ in range(40)]
    x = np.zeros((40, 12), bool)
    for d, terms in enumerate(corpus):
        x[d, terms] = True
    for seed in (0, 3, 7):
        for dedup in (True, False):
            assert T.recursive_construct_host(x, seed, 3, 3, dedup) == \
                J.recursive_construct_host(x, seed, 3, 3, dedup)
            assert T.bfs_construct_host(x, seed, 3, 3, 4, dedup) == \
                J.bfs_construct_host(x, seed, 3, 3, 4, dedup)
    np.testing.assert_array_equal(
        T.traversal_construct_dense(torch.from_numpy(x.astype(np.int8)))
        .numpy(),
        np.asarray(J.traversal_construct_dense(jnp.asarray(x, jnp.float32))))
    t_idx = T.pack_docs(corpus, 12, device="cpu")
    j_idx = J.pack_docs(corpus, 12)
    mask = T.and_term(t_idx, T.term_postings(t_idx, 3), 5)
    j_mask = J.and_term(j_idx, J.term_postings(j_idx, 3), 5)
    np.testing.assert_array_equal(T.to_uint32(mask), np.asarray(j_mask))
    assert int(T.mask_count(mask)) == int(J.mask_count(j_mask))
    np.testing.assert_array_equal(T.doc_freq_under(t_idx, mask).numpy(),
                                  np.asarray(J.doc_freq_under(j_idx, j_mask)))
    assert T.mask_count(mask).dtype == torch.int32


def test_corpus_stats_match():
    docs = TD.synthetic_csl(500, 300, seed=2)
    assert dataclasses.asdict(TD.corpus_stats(docs, 300)) == \
        dataclasses.asdict(JD.corpus_stats(docs, 300))
    assert dataclasses.astuple(TD.corpus_stats([[1]], 3)) == \
        dataclasses.astuple(JD.corpus_stats([[1]], 3))


def test_count_methods_view_is_live_like_the_reference():
    assert set(T.COUNT_METHODS) == set(J.COUNT_METHODS)
    assert len(T.COUNT_METHODS) == len(J.COUNT_METHODS)
    for name in ("gemm", "popcount", "pallas"):
        assert T.COUNT_METHODS[name] == J.COUNT_METHODS[name]
    # "fused" reads the index's own postings (ROADMAP.md §3 departures)
    assert T.COUNT_METHODS["fused"] == ()
    with pytest.raises(KeyError):
        T.COUNT_METHODS["nope"]
    T.register_count_method("surface_probe", ("x_dense",),
                            lambda i, m, o: None)
    try:
        assert T.COUNT_METHODS["surface_probe"] == ("x_dense",)
    finally:
        T.unregister_count_method("surface_probe")
    assert "surface_probe" not in T.COUNT_METHODS


# ---------------------------------------------------------------------------
# launch counters under threads
# ---------------------------------------------------------------------------


def test_launch_counts_lose_nothing_under_threads(monkeypatch):
    """The server's lanes launch from executor threads: with the kernel
    stubbed out, 8 threads' launches through the wrapper are all counted
    (an unguarded ``+=`` on the shared dict loses some)."""
    from repro_torch.kernels import postings
    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(postings, "postings_counts_cuda",
                        lambda masks, packed: masks)
    masks = torch.zeros((1, 1), dtype=torch.int32)
    n_threads, per = 8, 20000
    ops.reset_launches()
    start = threading.Barrier(n_threads)

    def work():
        start.wait()
        for _ in range(per):
            ops.postings_counts(masks, masks)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    try:
        assert ops.LAUNCHES["postings_counts"] == n_threads * per
    finally:
        ops.reset_launches()


# ---------------------------------------------------------------------------
# the launch layer
# ---------------------------------------------------------------------------

#: the launch layer's departures (ROADMAP.md §3): no compiled artifact,
#: so no ``from_compiled`` (the counter's ``from_counts`` stands there); no
#: ``shard_map_compat`` (the port's sharded execution is
#: ``core.distributed``'s single-controller loop); the per-device memory
#: comes from the plan's shardings, not from a compiled artifact
LAUNCH_GONE = {"launch.roofline": {"from_compiled"},
               "launch.sharding": {"shard_map_compat"}}
LAUNCH_RENAMED = {"compiled": "plan"}
LAUNCH_MODULES = ["launch.flags", "launch.mesh", "launch.sharding",
                  "launch.roofline", "launch.cells"]


@pytest.mark.parametrize("name", LAUNCH_MODULES)
def test_launch_surfaces_match(name):
    """``repro.<name>`` against ``repro_torch.<name>``: every function and
    class (private ones too) but :data:`LAUNCH_GONE` is in the port, with
    every keyword parameter (a dataclass's fields, a class's public
    methods); the port adds only keywords (``device=``, ``seed=``,
    ``host=``: the ``meta`` stand-ins and the ``--host`` run)."""
    ref = importlib.import_module(f"repro.{name}")
    port = importlib.import_module(f"repro_torch.{name}")
    gone = LAUNCH_GONE.get(name, set())
    names = _own_names(ref) - gone
    assert gone <= _own_names(ref) and not gone & set(dir(port))
    assert names - _own_names(port) == set()
    wrong = {}
    for n in sorted(names):
        r, p = getattr(ref, n), getattr(port, n)
        pairs = [(n, r, p)]
        if inspect.isclass(r):
            pairs += [(f"{n}.{m}", getattr(r, m), getattr(p, m, None))
                      for m, v in vars(r).items()
                      if not m.startswith("_") and callable(v)]
        for label, rr, pp in pairs:
            pr, pq = _params(rr), _params(pp)
            if pr is None or pq is None:
                continue
            if pq[:len(pr)] != [LAUNCH_RENAMED.get(a, a) for a in pr]:
                wrong[label] = (pr, pq)
    assert wrong == {}
    if name == "launch.mesh":
        for const in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW"):
            assert isinstance(getattr(port, const), float)
    if name == "launch.sharding":
        assert set(port.DEFAULT_RULES.items()) == set(
            ref.DEFAULT_RULES.items())


def _ast_functions(path):
    """The module-level functions of a source file and their parameters
    (the reference's dry-run sets XLA_FLAGS when imported, so it is
    read, not imported)."""
    import ast
    tree = ast.parse(Path(path).read_text())
    return {f.name: [a.arg for a in f.args.args + f.args.kwonlyargs]
            for f in tree.body if isinstance(f, ast.FunctionDef)}


def test_dryrun_surface_and_flags_match():
    from repro_torch.launch import dryrun
    ref_src = ROOT / "src" / "repro" / "launch" / "dryrun.py"
    port_src = Path(dryrun.__file__)
    ref, port = _ast_functions(ref_src), _ast_functions(port_src)
    assert set(ref) - set(port) == set()
    for n, params in ref.items():
        assert port[n][:len(params)] == [LAUNCH_RENAMED.get(a, a)
                                         for a in params], n
    flag = re.compile(r'add_argument\("(--[\w-]+)"')
    assert set(flag.findall(port_src.read_text())) == set(
        flag.findall(ref_src.read_text())) | {"--host"}
    assert "dryrun_torch" in dryrun.RESULTS_DIR
