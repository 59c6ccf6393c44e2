"""The port's logical-axis sharding (``repro_torch.launch.sharding``) and the
models' and optimizers' spec trees against the reference's
(``repro.launch.sharding``, ``param_specs``, ``cache_specs``,
``state_specs``), exact.

Every leaf of every arch's ``param_specs``, ``cache_specs`` (short and
long context) and optimizer ``state_specs`` resolves to the reference's
PartitionSpec on a (1, 1) mesh and at the production shapes (16, 16) and
(2, 16, 16).  The reference's ``_resolve_axis`` reads only
``mesh.shape``, so at the production shapes it is given a stand-in whose
``shape`` is the production mesh's; the port plans on ``meta`` grids of
those shapes.  Shapes come from each side's own ``init`` on placeholders
(``jax.eval_shape``; the port's ``init_*`` on ``meta``).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.sharding as RS  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import gnn as RG  # noqa: E402
from repro.models import recsys as RR  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.train.optimizer import make_optimizer as ref_optimizer  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.base import CoocConfig, GNNConfig, LMConfig  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.launch.cells import arg_tree  # noqa: E402
from repro_torch.models import gnn as G  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train.optimizer import make_optimizer  # noqa: E402

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = [a for a in list_archs()
         if not isinstance(get_config(a), CoocConfig)]
LM_ARCHS = [a for a in ARCHS if isinstance(get_config(a), LMConfig)]
# (batch, positions) of LM_SHAPES' decode cells: short and long context
CACHES = {False: (128, 32768), True: (1, 524288)}


def _port_mesh(name):
    shape, axes = MESHES[name]
    return M.make_mesh(shape, axes, ["meta"] * int(np.prod(shape)))


def _ref_specs(name, logical, shapes, rules=None):
    """The reference's resolution, keyed by leaf path, on a stand-in mesh
    of ``name``'s shape."""
    shape, axes = MESHES[name]
    merged = dict(RS.DEFAULT_RULES, **(rules or {}))
    stand_in = types.SimpleNamespace(shape=dict(zip(axes, shape)))
    tok = RS._ACTIVE.set(RS._Ctx(stand_in, merged))
    try:
        tree = RS.spec_tree(logical, shapes)
    finally:
        RS._ACTIVE.reset(tok)
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda v: isinstance(v, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _flat_specs(tree, path=()):
    if isinstance(tree, S.PartitionSpec):
        return {pytree.keystr(path): tuple(tree)}
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else enumerate(tree))
    return {k: v for key, sub in items
            for k, v in _flat_specs(sub, path + (key,)).items()}


def _port_specs(name, logical, shapes, rules=None):
    with S.axis_rules(_port_mesh(name), rules):
        return _flat_specs(S.spec_tree(logical, shapes))


def _shapes_ref(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): (tuple(x.shape), jnp.dtype(x.dtype).name)
            for p, x in flat}


def _shapes_port(tree):
    return {pytree.keystr(p): (tuple(x.shape),
                               str(x.dtype).replace("torch.", ""))
            for p, x in pytree.flatten_with_path(tree)}


def _both(arch):
    """(port config, port param shapes on meta, reference config, its
    param shapes) of ``arch`` at its published size."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    gen = torch.Generator()
    key = jax.random.PRNGKey(0)
    if isinstance(cfg, LMConfig):
        model = T.init_params(cfg, gen, device="meta")
        ref = jax.eval_shape(lambda: RT.init_params(rcfg, key))
    elif isinstance(cfg, GNNConfig):
        model = G.init_gin(cfg, gen, 32, 8, device="meta")
        ref = jax.eval_shape(lambda: RG.init_gin(rcfg, key, 32, 8))
    else:
        model = R.init_params(cfg, gen, device="meta")
        ref = jax.eval_shape(lambda: RR.init_params(rcfg, key))
    return cfg, arg_tree(model), rcfg, ref


def _param_specs(cfg, rcfg, params, ref):
    if isinstance(cfg, LMConfig):
        return T.param_specs(cfg), RT.param_specs(rcfg)
    if isinstance(cfg, GNNConfig):
        return G.param_specs(cfg, params), RG.param_specs(rcfg, ref)
    return R.param_specs(cfg, params), RR.param_specs(rcfg, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_resolve_as_the_reference(arch):
    """The logical trees are the reference's, and every leaf of the params
    and of the optimizer state resolves to its PartitionSpec on each
    mesh."""
    cfg, params, rcfg, ref = _both(arch)
    assert _shapes_port(params) == _shapes_ref(ref)
    pspec, rspec = _param_specs(cfg, rcfg, params, ref)
    assert pspec == rspec
    opt, ropt = make_optimizer(cfg), ref_optimizer(rcfg)
    state, rstate = opt.init(params), jax.eval_shape(ropt.init, ref)
    assert _shapes_port(state) == _shapes_ref(rstate)
    sspec = opt.state_specs(pspec)
    assert sspec == ropt.state_specs(rspec)
    for name in MESHES:
        want = _ref_specs(name, rspec, ref)
        assert _port_specs(name, pspec, params) == want
        assert _port_specs(name, sspec, state) == _ref_specs(
            name, sspec, rstate)


@pytest.mark.parametrize("long_context", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_specs_resolve_as_the_reference(arch, long_context):
    cfg, rcfg = get_config(arch), ref_config(arch)
    b, s = CACHES[long_context]
    cache = T.init_cache(cfg, b, s, device="meta")
    rcache = jax.eval_shape(lambda: RT.init_cache(rcfg, b, s, jnp.bfloat16))
    assert _shapes_port(cache) == _shapes_ref(rcache)
    logical = T.cache_specs(cfg, long_context=long_context)
    assert logical == RT.cache_specs(rcfg, long_context=long_context)
    for name in MESHES:
        assert _port_specs(name, logical, cache) == _ref_specs(
            name, logical, rcache)


def test_indivisible_heads_degrade_to_replication():
    """qwen1.5-32b's 40 KV heads do not split 16 ways: its cache keeps the
    sequence on "model" and replicates the heads, as the reference's."""
    cfg = get_config("qwen1.5-32b")
    assert cfg.n_kv_heads == 40
    b, s = CACHES[False]
    cache = T.init_cache(cfg, b, s, device="meta")
    logical = T.cache_specs(cfg, long_context=False)
    got = _port_specs("16x16", logical, cache)
    assert got["['kv']"] == (None, "data", "model", None, None)
    assert got == _ref_specs("16x16", logical, cache)
    # with the sequence axis taken off "model", the heads still do not
    # divide: replication again
    rules = {"seq": ()}
    got = _port_specs("16x16", logical, cache, rules)
    assert got["['kv']"][3] is None
    assert got == _ref_specs("16x16", logical, cache, rules)


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("axes,shape,rules", [
    (("batch", "batch"), (32, 32), None),          # one dim per mesh axis
    (("kv_seq", "batch", None), (64, 32, 5), None),  # kv_seq takes data first
    (("batch", "ff"), (8, 48), None),
    (("batch",), (8,), {"batch": ()}),             # rule override
    (("heads", "batch"), (32, 64), {"heads": ("data", "model")}),
    (("cand",), (1024,), None),
    (("weird", None), (7, 3), {"weird": ("data",)}),
    ((("batch", "ff"), None), (512, 2), None),      # a tuple of names
])
def test_logical_to_spec_matches_the_reference(name, axes, shape, rules):
    got = _port_specs(name, axes, shape, rules)[""]
    assert got == _ref_specs(name, axes, shape, rules)[""]
    flat = [a for e in got if e is not None
            for a in ((e,) if isinstance(e, str) else e)]
    assert len(flat) == len(set(flat))


def test_named_sharding_shards_and_constrain():
    mesh = M.make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    sh = S.NamedSharding(mesh, S.P("data", None))
    assert sh.shard_shape((8, 6)) == (4, 6)
    imap = sh.devices_indices_map((8, 6))
    assert imap[(1, 0)] == (slice(4, 8), slice(None)) == imap[(1, 1)]
    with pytest.raises(ValueError, match="does not split"):
        sh.shard_shape((7, 6))
    x = torch.ones(4, 4)
    assert S.constrain(x, ("batch", None)) is x
    with S.axis_rules(mesh):
        assert S.constrain(x, ("batch", "ff")) is x
        assert S.active_mesh() is mesh
        assert S.named_sharding(("batch", "ff"), x).spec == S.P("data",
                                                                "model")
    assert S.active_mesh() is None


def test_meshes():
    prod = M.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    assert {d.type for d in prod.devices.flat} == {"meta"}
    multi = M.make_production_mesh(multi_pod=True)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert M.make_host_mesh("cpu").shape == {"data": 1, "model": 1}
    from repro_torch.train import elastic
    assert elastic.DeviceMesh is M.DeviceMesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.make_host_mesh()
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW, M.ICI_BW) == (989e12, 3.35e12,
                                                       450e9)
