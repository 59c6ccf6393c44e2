"""The port's training substrate against the reference's, on the CPU:
the optimizers and the train step (3 steps from the same weights and
gradients), checkpoints both ways in the reference's format, the elastic
plans, the int8 compressed all-reduce against a numpy version, the
straggler watchdog, and ``launch/train.py``'s ``train()`` (resume, and 3
steps of deepseek-v2-lite-16b from the same weights as the reference's
``train()``).

Tolerances: parameters rtol 1e-5, atol 1e-6; moments rtol 1e-4 (atol
1e-7 for fp32 moments, one bf16 step for bf16 ones: a last-bit
difference of an fp32 sum can round to the neighbouring bf16 value).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.train as JT  # noqa: E402
from repro.launch import train as JL  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.configs import get_config, replace  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import checkpoint as TCK  # noqa: E402
from repro_torch.train import compression, elastic  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import (  # noqa: E402
    StragglerWatchdog,
    make_optimizer,
    make_train_step,
)

ROOT = Path(__file__).resolve().parent.parent
P_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _same_tree(got, want, **tol):
    g = {pytree.keystr(p): v for p, v in pytree.flatten_with_path(got)}
    w = {jax.tree_util.keystr(p): v for p, v in
         jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(_np(g[k]), _np(w[k]), err_msg=k, **tol)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((16, 8))).astype(np.float32),
            "b": (scale * rng.standard_normal((8,))).astype(np.float32),
            "stack": {"k": (scale * rng.standard_normal((3, 4, 5))
                            ).astype(np.float32)}}


def _torch_tree(t):
    return pytree.tree_map(lambda a: torch.from_numpy(np.array(a)), t)


# ---------------------------------------------------------------------------
# optimizers and the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_optimizer_three_updates_match_the_reference(name, moments):
    """Three updates from the same parameters and gradients (the first
    ones large enough to clip): parameters, every state leaf, grad_norm
    and lr."""
    cfg = replace(get_config("gin-tu"), optimizer=name, moment_dtype=moments,
                  learning_rate=0.05, weight_decay=0.1, warmup_steps=2)
    jcfg = JC.replace(JC.get_config("gin-tu"), optimizer=name,
                      moment_dtype=moments, learning_rate=0.05,
                      weight_decay=0.1, warmup_steps=2)
    p0 = _tree(0)
    jopt, topt = JO.make_optimizer(jcfg), TO.make_optimizer(cfg)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init(jp)
    tp = _torch_tree(p0)
    ts = topt.init(tp)
    m_tol = (dict(rtol=1e-4, atol=1e-7) if moments == "float32" else
             dict(rtol=2 ** -7, atol=1e-7))
    for step in range(3):
        g = _tree(10 + step, scale=1.0 if step else 3.0)
        jp, js, jstats = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tstats = topt.update(_torch_tree(g), ts, tp)
        _same_tree(tp, jp, **P_TOL)
        assert sorted(ts) == sorted(js)
        assert ts["count"].dtype == torch.int32 and ts["count"].dim() == 0
        assert int(ts["count"]) == int(js["count"]) == step + 1
        for k in ts:
            if k != "count":
                assert ({str(v.dtype).replace("torch.", "") for v in
                         pytree.leaves(ts[k])}
                        == {str(v.dtype) for v in jax.tree.leaves(js[k])})
                _same_tree(ts[k], js[k], **m_tol)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=1e-6)


def test_adafactor_state_is_factored_over_the_reference_leaf():
    """A stack of layers is one leaf, as in the reference: its row
    statistics keep the layer axis, its column statistics too."""
    opt = TO.adafactor(get_config("kimi-k2-1t-a32b"))
    st = opt.init({"w": torch.zeros(64, 32), "b": torch.zeros(64),
                   "stack": torch.zeros(3, 64, 32)})
    assert st["vr"]["w"].shape == (64,) and st["vc"]["w"].shape == (32,)
    assert st["vr"]["b"].shape == (64,) and st["vc"]["b"].shape == ()
    assert st["vr"]["stack"].shape == (3, 64)
    assert st["vc"]["stack"].shape == (3, 32)
    assert st["m"]["w"].dtype == torch.bfloat16


def test_optimizers_are_not_torch_optim():
    """``torch.optim.AdamW`` has no schedule and no global-norm clip: three
    steps of it, at the reference's first-step lr, leave other weights than
    the reference's AdamW (one step alone agrees: its eps and decoupled
    decay are placed alike)."""
    cfg = replace(get_config("gin-tu"), learning_rate=0.05, weight_decay=0.1,
                  warmup_steps=10, grad_clip=1.0)
    jcfg = JC.replace(JC.get_config("gin-tu"), learning_rate=0.05,
                      weight_decay=0.1, warmup_steps=10, grad_clip=1.0)
    p0 = {"w": np.linspace(-1, 1, 12, dtype=np.float32)}
    ours, ref = TO.adamw(cfg), JO.adamw(jcfg)
    mine = _torch_tree(p0)
    st = ours.init(mine)
    jp = jax.tree.map(jnp.asarray, p0)
    js = ref.init(jp)
    w = torch.nn.Parameter(torch.from_numpy(p0["w"].copy()))
    tor = torch.optim.AdamW([w], lr=float(TO.lr_schedule(cfg, torch.tensor(
        1))), betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
    for k in range(3):
        g = {"w": np.linspace(2.0, -1.5, 12, dtype=np.float32) * (k + 1)}
        mine, st, _ = ours.update(_torch_tree(g), st, mine)
        jp, js, _ = ref.update(jax.tree.map(jnp.asarray, g), js, jp)
        w.grad = torch.from_numpy(g["w"].copy())
        tor.step()
    np.testing.assert_allclose(mine["w"].numpy(), np.asarray(jp["w"]),
                               **P_TOL)
    assert np.abs(w.detach().numpy() - np.asarray(jp["w"])).max() > 1e-3


class _Quad(torch.nn.Module):
    def __init__(self, d=8):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(d, 1))
        self.b = torch.nn.Parameter(torch.zeros(1))


def _quad_loss(model, batch):
    pred = batch["x"] @ model.w + model.b
    loss = torch.mean((pred - batch["y"]) ** 2)
    return loss, {"loss": loss}


def _jquad_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = jnp.mean((pred - batch["y"]) ** 2)
    return loss, {"loss": loss}


def _toy(n=64, d=8):
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((d, 1)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = x @ w_true + 0.01 * rng.standard_normal((n, 1)).astype(np.float32)
    return {"x": x, "y": y}


@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_three_steps_match_the_reference(microbatches):
    """``make_train_step``: single, and accumulated over 4 microbatches
    (the per-microbatch gradient and loss divided by n); loss, grad_norm,
    lr and the parameters after each of 3 steps."""
    kw = dict(microbatches=microbatches, learning_rate=0.1, warmup_steps=1,
              weight_decay=0.01)
    cfg = replace(get_config("gin-tu"), **kw)
    jcfg = JC.replace(JC.get_config("gin-tu"), **kw)
    batch = _toy()
    jstep = JT.make_train_step(jcfg, _jquad_loss, JO.make_optimizer(jcfg))
    tstep = make_train_step(cfg, _quad_loss, make_optimizer(cfg))
    jp = {"w": jnp.zeros((8, 1)), "b": jnp.zeros((1,))}
    js = JO.make_optimizer(jcfg).init(jp)
    model = _Quad()
    ts = make_optimizer(cfg).init(pytree.module_tree(model))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(3):
        jp, js, jm = jstep(jp, js, jb)
        model, ts, tm = tstep(model, ts, tb)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-7)
        _same_tree(pytree.module_tree(model), jp, **P_TOL)
    assert not any(p.grad is not None for p in model.parameters())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _ckpt_tree():
    return ({"table": torch.arange(12, dtype=torch.float32).reshape(3, 4),
             "bot": [{"w": torch.ones(2, 2), "b": torch.zeros(2)}]},
            {"m": {"table": torch.full((3, 4), 0.5, dtype=torch.bfloat16)},
             "count": torch.tensor(7, dtype=torch.int32)})


def test_checkpoint_keys_and_files_are_the_reference_s(tmp_path):
    """The same tree saved by each package: identical manifests, equal
    arrays (bf16 as raw bytes), and each restores the other's."""
    tree = _ckpt_tree()
    jtree = jax.tree.map(lambda t: jnp.asarray(_np(t)).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else
        jnp.dtype(str(t.dtype).replace("torch.", ""))), tree)
    TCK.save(str(tmp_path / "port"), 5, tree)
    JCK.save(str(tmp_path / "ref"), 5, jtree)
    import json
    mp, mr = (json.loads((tmp_path / d / "step_00000005" / "manifest.json"
                          ).read_text()) for d in ("port", "ref"))
    assert mp == mr
    assert [l["key"] for l in mp["leaves"]] == [
        "[0]['bot'][0]['b']", "[0]['bot'][0]['w']", "[0]['table']",
        "[1]['count']", "[1]['m']['table']"]
    assert [l["raw"] for l in mp["leaves"]] == [False] * 4 + [True]
    for leaf in mp["leaves"]:
        a = np.load(tmp_path / "port" / "step_00000005" / leaf["file"])
        b = np.load(tmp_path / "ref" / "step_00000005" / leaf["file"])
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the reference's checkpoint restored by the port, and back
    got, step = TCK.restore(str(tmp_path / "ref"), tree)
    assert step == 5
    for (path, g), (_, w) in zip(pytree.flatten_with_path(got),
                                 pytree.flatten_with_path(tree)):
        assert g.dtype == w.dtype and torch.equal(g, w), path
    back, _ = JCK.restore(str(tmp_path / "port"), jtree)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w, np.float32))


def test_checkpoint_keep_last_n_and_no_tmp(tmp_path):
    tree = {"x": torch.zeros(2)}
    for s in range(6):
        TCK.save(str(tmp_path), s, tree, keep=3)
    assert TCK.all_steps(str(tmp_path)) == [3, 4, 5]
    assert TCK.latest_step(str(tmp_path)) == 5
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    with pytest.raises(FileNotFoundError):
        TCK.restore(str(tmp_path / "none"), tree)


def test_async_save_is_taken_before_the_next_step(tmp_path):
    """``save(blocking=False)`` copies every leaf before it returns: an
    in-place optimizer step between it and ``join`` changes nothing on
    disk."""
    cfg = replace(get_config("gin-tu"), learning_rate=0.5, warmup_steps=1)
    model = _Quad()
    opt = make_optimizer(cfg)
    st = opt.init(pytree.module_tree(model))
    step = make_train_step(cfg, _quad_loss, opt)
    b = {k: torch.from_numpy(v) for k, v in _toy().items()}
    model, st, _ = step(model, st, b)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m_before = st["m"]["w"].clone()
    t = TCK.save(str(tmp_path), 1, (pytree.module_tree(model), st),
                 blocking=False)
    model, st, _ = step(model, st, b)             # in place, during the write
    t.join()
    assert not torch.equal(model.w.detach(), before["w"])
    (p, s), _ = TCK.restore(str(tmp_path), (pytree.module_tree(model), st))
    assert torch.equal(p["w"], before["w"]) and torch.equal(p["b"],
                                                            before["b"])
    assert torch.equal(s["m"]["w"], m_before) and int(s["count"]) == 1


def test_params_and_state_carry_across_both_ways():
    """``params_to_reference`` inverts ``params_from_reference`` (layers
    stacked as the reference stacks them); the optimizer state crosses
    with ``opt_state_to_reference`` / ``opt_state_from_reference``."""
    jcfg = JL.reduced_config(JC.get_config("deepseek-v2-lite-16b"))
    cfg = TL.reduced_config(get_config("deepseek-v2-lite-16b"))
    params = JL.init_params(jcfg, jax.random.PRNGKey(0))
    model = TT.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                     device="cpu")
    back = TT.params_to_reference(cfg, model)
    _same_tree(back, params, rtol=0, atol=0)
    jstate = JO.make_optimizer(jcfg).init(params)
    st = TO.opt_state_from_reference(jax.tree.map(np.asarray, jstate),
                                     device="cpu")
    out = TO.opt_state_to_reference(st)
    assert out["count"].dtype == torch.int32
    for k in ("m", "v"):
        _same_tree(out[k], jstate[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# elastic plans, compression, the straggler watchdog
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
def test_plan_mesh_and_simulate_failure_equal_the_reference(multi_pod):
    for n in (1, 3, 8, 16, 31, 64, 512):
        for mp in (1, 4, 16):
            a = elastic.plan_mesh(n, model_parallel=mp, multi_pod=multi_pod)
            b = JT.plan_mesh(n, model_parallel=mp, multi_pod=multi_pod)
            assert (a.shape, a.axes, a.n_devices) == (b.shape, b.axes,
                                                      b.n_devices)
            for failed in (0, 1, n // 2):
                got = elastic.simulate_failure(n + failed, failed,
                                               model_parallel=mp,
                                               multi_pod=multi_pod)
                want = JT.simulate_failure(n + failed, failed,
                                           model_parallel=mp,
                                           multi_pod=multi_pod)
                assert [(p.shape, p.axes) for p in got] == [
                    (p.shape, p.axes) for p in want]


def test_build_mesh_lays_the_plan_over_the_devices():
    mesh = elastic.build_mesh(elastic.plan_mesh(4, model_parallel=2),
                              ["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elastic.build_mesh(elastic.plan_mesh(1))


def _np_compressed(gs, rs):
    """The protocol in numpy: pmax, int8, int32 sum in shard order."""
    es = [g.astype(np.float32) + r for g, r in zip(gs, rs)]
    gmax = max(np.abs(e).max() for e in es)
    scale = np.maximum(np.float32(gmax) / np.float32(127.0),
                       np.float32(1e-12))
    qs = [np.clip(np.round(e / scale), -127, 127).astype(np.int8)
          for e in es]
    qsum = sum(q.astype(np.int32) for q in qs)
    mean = qsum.astype(np.float32) * scale / np.float32(len(gs))
    return mean, [e - q.astype(np.float32) * scale for e, q in zip(es, qs)]


@pytest.mark.parametrize("n", [1, 4])
def test_compressed_psum_protocol_matches_numpy(n):
    rng = np.random.default_rng(n)
    gs = [{"w": rng.standard_normal((6, 5)).astype(np.float32),
           "b": rng.standard_normal(5).astype(np.float32)} for _ in range(n)]
    rs = [{k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in g.items()} for g in gs]
    mean, res = compression.compressed_psum(
        [_torch_tree(g) for g in gs], [_torch_tree(r) for r in rs],
        ("data",), n)
    for k in ("w", "b"):
        want_mean, want_res = _np_compressed([g[k] for g in gs],
                                             [r[k] for r in rs])
        for i in range(n):
            np.testing.assert_allclose(mean[i][k].numpy(), want_mean,
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(res[i][k].numpy(), want_res[i],
                                       rtol=1e-6, atol=1e-7)
    if n == 1:
        # residual + the quantised mean is the gradient (error feedback)
        np.testing.assert_allclose(mean[0]["w"].numpy() + res[0]["w"].numpy(),
                                   gs[0]["w"] + rs[0]["w"], rtol=1e-5,
                                   atol=1e-6)


def test_ddp_step_on_four_cpu_shards_trains():
    """``make_ddp_train_step`` over 4 shards of the CPU: each shard keeps
    its residual; the update follows the compressed mean gradient."""
    cfg = replace(get_config("gin-tu"), learning_rate=0.05, warmup_steps=1,
                  weight_decay=0.0, grad_clip=0.0)
    mesh = elastic.build_mesh(elastic.MeshPlan((4, 1), ("data", "model")),
                              ["cpu"] * 4)
    opt = make_optimizer(cfg)
    model = _Quad()
    st = opt.init(pytree.module_tree(model))
    step = compression.make_ddp_train_step(mesh, ("data",), _quad_loss, opt)
    b = {k: torch.from_numpy(v) for k, v in _toy().items()}
    res = compression.init_residual(model)
    l0 = float(_quad_loss(model, b)[0])
    for _ in range(40):
        model, st, res, stats = step(model, st, res, b)
    assert len(res) == 4 and sorted(stats) == ["grad_norm", "lr"]
    assert float(_quad_loss(model, b)[0]) < 0.5 * l0


def test_straggler_watchdog_flags_as_the_reference():
    for dog_cls in (StragglerWatchdog, JT.StragglerWatchdog):
        calls = []
        dog = dog_cls(threshold=2.0, min_samples=3,
                      backup_dispatch=calls.append)
        for s in range(10):
            dog.observe(s, 0.1)
        ev = dog.observe(10, 0.5)
        assert ev is not None and ev.ratio == pytest.approx(5.0)
        assert calls == [10]
        quiet = dog_cls(threshold=3.0, min_samples=3)
        for s in range(10):
            assert quiet.observe(s, 0.1 + 0.01 * (s % 2)) is None
        assert quiet.stats()["n_straggler_events"] == 0.0


# ---------------------------------------------------------------------------
# train()
# ---------------------------------------------------------------------------


def test_train_resume_continues(tmp_path, capsys):
    """The reference's ``test_train_resume_continues`` on the port, and a
    resumed run's last loss equals an uninterrupted one's."""
    d = str(tmp_path / "a")
    out1 = TL.train("gin-tu", steps=6, ckpt_dir=d, ckpt_every=3,
                    log_every=100, async_ckpt=False, device="cpu")
    assert np.isfinite(out1["loss"]) and TCK.all_steps(d) == [3, 6]
    out2 = TL.train("gin-tu", steps=8, ckpt_dir=d, ckpt_every=3,
                    log_every=100, device="cpu")
    assert "resumed from step 6" in capsys.readouterr().out
    whole = TL.train("gin-tu", steps=8, log_every=100, device="cpu")
    np.testing.assert_allclose(out2["loss"], whole["loss"], rtol=1e-5,
                               atol=1e-6)
    assert TCK.all_steps(d) == [3, 6, 8]


def test_train_runs_on_the_card_unless_asked():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.train("gin-tu", steps=1)
    with pytest.raises(ValueError, match="query workload"):
        TL.train("cooccur-csl", device="cpu")


def test_train_deepseek_matches_the_reference_from_the_same_weights(tmp_path):
    """Both packages' ``train()`` resume from one step-0 checkpoint (the
    reference's weights and optimizer state) and run 3 steps: the final
    losses and the step-3 checkpoints agree."""
    arch = "deepseek-v2-lite-16b"
    jcfg = JL.reduced_config(JC.get_config(arch))
    params = JL.init_params(jcfg, jax.random.PRNGKey(7))
    state = JO.make_optimizer(jcfg).init(params)
    for d in ("ref", "port"):
        JCK.save(str(tmp_path / d), 0, (params, state))
    want = JL.train(arch, steps=3, batch=4, seq=16, log_every=100,
                    ckpt_dir=str(tmp_path / "ref"))
    got = TL.train(arch, steps=3, batch=4, seq=16, log_every=100,
                   ckpt_dir=str(tmp_path / "port"), device="cpu")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                               atol=1e-6)
    (jp, js), _ = JCK.restore(str(tmp_path / "ref"), (params, state))
    cfg = TL.reduced_config(get_config(arch))
    model = TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tst = make_optimizer(cfg).init(pytree.module_tree(model))
    (tp, ts), step = TCK.restore(str(tmp_path / "port"),
                                 (pytree.module_tree(model), tst))
    assert step == 3
    _same_tree(tp, jp, **P_TOL)
    _same_tree(ts["m"], js["m"], rtol=1e-4, atol=1e-7)


_BLOCKED = """
import sys
sys.modules["jax"] = None          # any import of jax or repro now raises
sys.modules["repro"] = None
import repro_torch.train, repro_torch.launch.train, repro_torch.pytree
from repro_torch.train import checkpoint, compression, elastic, optimizer
from repro_torch.train import step, straggler
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m == "repro" or m.startswith(("repro.", "jax"))))
print(leaked)
"""


def test_training_modules_import_with_jax_and_repro_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
