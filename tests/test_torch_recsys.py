"""The port's DLRM serving path against the JAX reference's, on the CPU.

Parameters come from the reference's ``init_params`` (as numpy) at
``reduced_config(dlrm-rm2)``, the published widths with 1,000 rows per
field, and are carried across by ``params_from_reference``; batches come
from both packages' ``recsys_batch``.  Probabilities agree at atol 1e-6,
logits at rtol 1e-4 / atol 1e-5: the fp32 sums of four MLP layers and the
interaction are taken in another order.  The kernel itself is held against
its plain version in ``test_torch_gpu.py`` (marker ``gpu``).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.data.pipeline import recsys_batch as jax_batch  # noqa: E402
from repro.launch.train import reduced_config  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro_torch.configs import RecSysConfig, get_config, replace  # noqa: E402
from repro_torch.data import recsys_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def reference():
    jcfg = reduced_config(jax_config("dlrm-rm2"))
    params = JR.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = replace(get_config("dlrm-rm2"), vocab_per_field=1000, n_items=1000)
    model = R.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return jcfg, params, cfg, model


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_config_is_the_references():
    jcfg = jax_config("dlrm-rm2")
    cfg = get_config("dlrm-rm2")
    for field in ("name", "interaction", "n_dense", "n_sparse",
                  "vocab_per_field", "embed_dim", "bot_mlp", "top_mlp",
                  "optimizer", "learning_rate", "weight_decay"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert [(s.name, s.kind, s.dims) for s in cfg.shapes] == [
        (s.name, s.kind, s.dims) for s in jcfg.shapes]
    assert cfg.shape("serve_bulk")["batch"] == 262144
    assert get_config("cooccur-csl").vocab_size == 65536
    with pytest.raises(KeyError):
        get_config("dlrm-rm3")


def test_params_from_reference_carry_every_weight(reference):
    jcfg, params, cfg, model = reference
    assert model.table.shape == (26 * 1000, 64)
    np.testing.assert_array_equal(model.table.detach().numpy(),
                                  np.asarray(params["table"]))
    dims = [tuple(w.shape) for w in model.bot.w] + [
        tuple(w.shape) for w in model.top.w]
    assert dims == [(13, 512), (512, 256), (256, 64),
                    (64 + 27 * 26 // 2, 512), (512, 512), (512, 256),
                    (256, 1)]
    for mlp, layers in ((model.bot, params["bot"]), (model.top, params["top"])):
        for w, b, layer in zip(mlp.w, mlp.b, layers):
            np.testing.assert_array_equal(w.detach().numpy(),
                                          np.asarray(layer["w"]))
            np.testing.assert_array_equal(b.detach().numpy(),
                                          np.asarray(layer["b"]))


@pytest.mark.parametrize("step", [0, 7])
def test_recsys_batch_is_the_references_bit_for_bit(step):
    cfg = replace(get_config("dlrm-rm2"), vocab_per_field=1000)
    jcfg = reduced_config(jax_config("dlrm-rm2"))
    got, want = recsys_batch(cfg, 64, step, seed=3), jax_batch(jcfg, 64, step,
                                                               seed=3)
    assert sorted(got) == sorted(want) == ["dense", "labels", "sparse_ids"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_serve_fn_matches_reference(reference):
    jcfg, params, cfg, model = reference
    batch = recsys_batch(cfg, 64, 1)
    want = np.asarray(JR.serve_fn(jcfg, params, _jax(batch)))
    got = R.serve_fn(cfg, model, R.as_batch(batch, "cpu"))
    assert got.dtype == torch.float32 and got.shape == (64,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_retrieval_fn_matches_reference(reference):
    """One query against 1,000 candidates, candidate-major: logits."""
    jcfg, params, cfg, model = reference
    batch = recsys_batch(cfg, 1000, 2, seed=1)
    want = np.asarray(JR.retrieval_fn(jcfg, params, _jax(batch)))
    got = R.retrieval_fn(cfg, model, R.as_batch(batch, "cpu"))
    assert got.shape == (1000,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_dlrm_logits_run_the_interaction_once(reference, monkeypatch):
    """The interaction input is (B, F + 1, E) with the bottom MLP's output
    in slot 0 and the embeddings in slots 1..F, and the logits go through
    ``ops.dot_interaction`` once."""
    _, _, cfg, model = reference
    batch = R.as_batch(recsys_batch(cfg, 5, 0), "cpu")
    dense_vec, x = R.interaction_input(cfg, model, batch)
    assert x.shape == (5, 27, 64) and x.is_contiguous()
    assert torch.equal(x[:, 0], dense_vec)
    rows = batch["sparse_ids"].long() + torch.arange(26) * 1000
    assert torch.equal(x[:, 1:], model.table[rows])
    calls = []
    real = ops.dot_interaction
    monkeypatch.setattr(ops, "dot_interaction",
                        lambda t: calls.append(t.shape) or real(t))
    R.dlrm_logits(cfg, model, batch)
    assert calls == [(5, 27, 64)]


def test_init_params_draw_from_the_generator():
    cfg = replace(get_config("dlrm-rm2"), vocab_per_field=50)
    a = R.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = R.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    c = R.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert not torch.equal(a.table, c.table)
    assert abs(float(a.table.std()) - 0.01) < 1e-3
    w = a.top.w[0]
    assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.05
    assert all((b_ == 0).all() for b_ in a.bot.b)
    probs = R.serve_fn(cfg, a, R.as_batch(recsys_batch(cfg, 8, 0), "cpu"))
    assert bool(torch.isfinite(probs).all())
    assert bool(((probs > 0) & (probs < 1)).all())


@pytest.mark.parametrize("interaction,shape", [
    ("fm", (4,)), ("dot", (4,)), ("self-attn-seq", (4, 3)),
    ("bidir-seq", (4, 3))])
def test_every_interaction_is_served(interaction, shape):
    """A small config of each interaction initialises, serves a batch
    (probabilities, or scores against 3 candidates) and scores
    candidates: finite values of the expected shapes."""
    cfg = RecSysConfig(name="x", interaction=interaction, n_sparse=3,
                       n_dense=2 if interaction == "dot" else 0,
                       vocab_per_field=5, embed_dim=4, mlp=(6,),
                       bot_mlp=(5, 4), top_mlp=(5, 1), n_items=7,
                       seq_len=4, n_blocks=1, n_heads=2)
    model = R.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    batch = R.as_batch(recsys_batch(cfg, 4, 0), "cpu")
    if "seq" in batch:
        batch["candidates"] = torch.randint(0, 9, (4, 3))
    out = R.serve_fn(cfg, model, batch)
    assert out.shape == shape and bool(torch.isfinite(out).all())
    if "seq" in batch:
        batch = {"seq": batch["seq"][:1], "candidates": torch.arange(9)}
    scores = R.retrieval_fn(cfg, model, batch)
    assert scores.shape == ((4,) if len(shape) == 1 else (1, 9))
    assert bool(torch.isfinite(scores).all())


def test_dlrm_refuses_the_cpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = replace(get_config("dlrm-rm2"), vocab_per_field=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.init_params(cfg, torch.Generator())


_BLOCKED = """
import sys
sys.modules["jax"] = None          # any import of jax or repro now raises
sys.modules["repro"] = None
import repro_torch.models.recsys, repro_torch.kernels.ops
import repro_torch.kernels.dot_interaction, repro_torch.kernels.flash_decode
import repro_torch.configs, repro_torch.data.pipeline
sys.path.insert(0, sys.argv[1])
import chip_smoke
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m == "repro" or m.startswith(("repro.", "jax"))))
print(leaked)
"""


def test_dlrm_and_decode_modules_import_with_jax_and_repro_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED, str(ROOT)],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
