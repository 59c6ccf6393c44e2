"""Reshard-on-restore: ``repro_torch.train.checkpoint.restore(shardings=)``
against the reference's.

A checkpoint written by the reference restores in the port shard by
shard onto a grid of four CPU devices under ``("data", None)`` and
``(None, "model")``: every shard equals the slice the reference's
``NamedSharding.devices_indices_map`` names for that grid position (taken
in a subprocess with 8 forced host devices, as
``tests/test_sharding.py::test_mini_dryrun_8_virtual_devices`` forces
them).  The reference's two restore tests are mirrored, and a dlrm-rm2
train state at its ``reduced_config`` restored under its ``param_specs``
and ``state_specs`` trains on to the uninterrupted run's losses.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.train import checkpoint as JC  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = {"rows": ("data", None), "cols": (None, "model")}

# the reference's shard index of every grid position of a (2, 2) mesh
REF_INDICES = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    out = {}
    for name, spec in json.loads(os.environ["SPECS"]).items():
        for shape in ([8, 6], [4, 6, 2]):
            imap = NamedSharding(mesh, P(*spec)).devices_indices_map(
                tuple(shape))
            out[f"{name}{shape}"] = {
                str(pos): [list(s.indices(n))[:2]
                           for s, n in zip(imap[mesh.devices[pos]], shape)]
                for pos in np.ndindex(2, 2)}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_indices():
    env = {**os.environ, "PYTHONPATH": "src", "SPECS": json.dumps(SPECS)}
    r = subprocess.run([sys.executable, "-c", REF_INDICES], env=env,
                       capture_output=True, text=True, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _grid(shape=(2, 2)):
    return make_mesh(shape, ("data", "model"), ["cpu"] * int(np.prod(shape)))


def _tree():
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal((8, 6)).astype(np.float32),
            "b": jnp.asarray(rng.standard_normal((4, 6, 2)), jnp.bfloat16),
            "c": np.arange(48, dtype=np.int32).reshape(8, 6)}


def _host(leaf):
    if hasattr(leaf, "dtype") and str(leaf.dtype) == "bfloat16":
        bits = np.array(np.asarray(leaf).view(np.int16))
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(leaf))


@pytest.mark.parametrize("name", list(SPECS))
def test_reference_checkpoint_restores_shard_by_shard(tmp_path, name,
                                                      ref_indices):
    tree = _tree()
    JC.save(str(tmp_path), 3, tree)
    mesh = _grid()
    spec = S.P(*SPECS[name])
    shardings = {k: S.NamedSharding(mesh, spec) for k in tree}
    template = {k: torch.empty(0) for k in tree}
    got, step = checkpoint.restore(str(tmp_path), template,
                                   shardings=shardings)
    assert step == 3
    for k, leaf in got.items():
        want = _host(tree[k])
        assert isinstance(leaf, S.ShardedTensor)
        assert leaf.sharding is shardings[k]
        assert tuple(leaf.shape) == tuple(want.shape)
        assert leaf.dtype == want.dtype
        ref = ref_indices[f"{name}{list(want.shape)}"]
        assert len(leaf.shards) == 4
        for pos, shard in leaf.shards.items():
            idx = tuple(slice(a, b) for a, b in ref[str(pos)])
            assert shard.device == torch.device("cpu")
            assert torch.equal(shard, want[idx])
            assert tuple(shard.shape) == tuple(
                leaf.sharding.shard_shape(want.shape))
        assert torch.equal(leaf.gather(), want)


def test_restore_with_shardings(tmp_path):
    """The reference's test: a one-device mesh puts the whole leaf on one
    device, so it comes back a plain tensor there."""
    mesh = make_mesh((1,), ("data",), ["cpu"])
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    checkpoint.save(str(tmp_path), 1, tree)
    sh = {"w": S.NamedSharding(mesh, S.P("data", None))}
    restored, _ = checkpoint.restore(str(tmp_path), tree, shardings=sh)
    assert type(restored["w"]) is torch.Tensor
    assert torch.equal(restored["w"], tree["w"])


def test_restore_onto_smaller_mesh(tmp_path):
    """Checkpoint written under one layout restores under another: the
    reference's test (replicated on one device), then from a 4-device
    grid's shards to a 2-device grid's."""
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    checkpoint.save(str(tmp_path), 2, tree)
    mesh = make_mesh((1,), ("data",), ["cpu"])
    restored, _ = checkpoint.restore(
        str(tmp_path), tree,
        shardings={"w": S.NamedSharding(mesh, S.P(None, None))})
    assert torch.equal(restored["w"], tree["w"])
    big, _ = checkpoint.restore(str(tmp_path), tree, shardings={
        "w": S.NamedSharding(_grid((4, 1)), S.P("data", None))})
    assert len(big["w"].shards) == 4
    checkpoint.save(str(tmp_path), 3, {"w": big["w"].gather()})
    small, _ = checkpoint.restore(str(tmp_path), tree, shardings={
        "w": S.NamedSharding(_grid((2, 1)), S.P("data", None))})
    assert [tuple(s.shape) for s in small["w"].shards.values()] == [(4, 8)] * 2
    assert torch.equal(small["w"].gather(), tree["w"])


def test_restore_takes_shardings_or_device(tmp_path):
    tree = {"w": torch.zeros(2)}
    checkpoint.save(str(tmp_path), 1, tree)
    mesh = make_mesh((1,), ("data",), ["cpu"])
    with pytest.raises(ValueError, match="not both"):
        checkpoint.restore(str(tmp_path), tree, device="cpu", shardings={
            "w": S.NamedSharding(mesh, S.P(None))})


def test_dlrm_train_state_restores_under_its_specs_and_trains_on(tmp_path):
    """dlrm-rm2 at its reduced_config: 2 steps, a checkpoint, 2 more; the
    checkpoint restored under ``param_specs`` / ``state_specs`` on a
    (2, 2) CPU grid (the table's rows split over "model"), gathered into a
    fresh model, trains on to the same losses, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as TL
    from repro_torch.models import recsys as R
    from repro_torch.train import make_optimizer, make_train_step

    cfg = TL.reduced_config(get_config("dlrm-rm2"))
    opt = make_optimizer(cfg)
    step_fn = make_train_step(cfg, TL.make_loss(cfg), opt)
    batch_fn = TL.make_batch_fn(cfg, 16, 8, "cpu")

    def run(model, state, steps):
        losses = []
        for s in steps:
            model, state, m = step_fn(model, state, batch_fn(s))
            losses.append(float(m["loss"]))
        return losses

    model = TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = opt.init(pytree.module_tree(model))
    run(model, state, range(2))
    checkpoint.save(str(tmp_path), 2, (pytree.module_tree(model), state))
    want = run(model, state, range(2, 4))

    fresh = TL.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    params = pytree.module_tree(fresh)
    template = (params, opt.init(params))
    pspec = R.param_specs(cfg, params)
    with S.axis_rules(_grid()):
        shardings = S.sharding_tree((pspec, opt.state_specs(pspec)),
                                    template)
    (got_p, got_s), step = checkpoint.restore(str(tmp_path), template,
                                              shardings=shardings)
    assert step == 2
    table = got_p["table"]
    assert isinstance(table, S.ShardedTensor)
    assert tuple(table.sharding.spec) == ("model", None)
    assert table.shards[(0, 1)].shape[0] == table.shape[0] // 2
    gather = lambda x: x.gather() if isinstance(x, S.ShardedTensor) else x
    got_p, got_s = pytree.tree_map(gather, got_p), pytree.tree_map(gather,
                                                                   got_s)
    pytree.load_module_tree(fresh, got_p)
    assert run(fresh, got_s, range(2, 4)) == want
