"""The port's gradients against ``jax.grad`` of the reference, on the CPU.

Every model's loss at the reference's ``reduced_config`` (the LM in fp32,
as ``launch/train.py`` initialises it): the weights come from the
reference's ``init_params`` and are carried across by
``params_from_reference``; batches come from a seed through numpy.  Each
gradient leaf is held to the reference's at the same pytree path, fp32,
rtol 1e-4, atol 1e-5.  Kernel 4's backward (``dot_interaction_grad_ref``)
is held to ``jax.grad`` of the reference's plain interaction, to
``gradcheck`` in float64 and to autograd through the plain forward.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.data import gnn_synthetic_graph as jax_graph  # noqa: E402
from repro.data import lm_batch as jax_lm_batch  # noqa: E402
from repro.data import recsys_batch as jax_recsys_batch  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import ref as JK  # noqa: E402
from repro.launch.train import reduced_config  # noqa: E402
from repro.models import gnn as JG  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.configs import get_config, replace  # noqa: E402
from repro_torch.kernels import dot_interaction as DI  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import gnn as G  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)


def _port_config(jcfg):
    """The port's config with every field of the reference's."""
    cfg = get_config(jcfg.name)
    fields = {k: getattr(jcfg, k) for k in cfg.__dataclass_fields__
              if k not in ("shapes",)}
    return replace(cfg, **fields)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _hold_grads(port_model, port_grads, jax_grads):
    """Every leaf of the reference's gradient == the port's at its
    path."""
    got = dict((pytree.keystr(p), leaf) for p, leaf in
               pytree.flatten_with_path(pytree.module_tree(port_model,
                                                           port_grads)))
    want = {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(jax_grads)[0]}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(_np(got[k]), np.asarray(w, np.float32),
                                   err_msg=k, **TOL)


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the models' losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-lite-16b",
                                  "kimi-k2-1t-a32b"])
def test_lm_loss_gradients_match_jax_grad(arch):
    """``transformer.loss_fn``: dense GQA, MLA with MoE (capacity 1.25,
    overflow dropped) and shared experts; the chunked cross-entropy over
    two chunks and the router's aux loss."""
    jcfg = reduced_config(JC.get_config(arch))
    cfg = _port_config(jcfg)
    params = JT.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    model = T.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    batch = jax_lm_batch(jcfg, 2, 16, 3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, wm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, jb, ce_chunk=8), has_aux=True)(params)
    loss, metrics, grads = loss_and_grads(
        lambda m, b: T.loss_fn(cfg, m, b, ce_chunk=8), model,
        _tensors(batch))
    assert sorted(metrics) == sorted(wm) == ["aux", "ce", "loss", "tokens"]
    for k in wm:
        np.testing.assert_allclose(float(metrics[k]), float(wm[k]), **TOL)
    _hold_grads(model, grads, jg)


def test_lm_remat_changes_no_gradient():
    """``cfg.remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``): the loss and every gradient are the
    same."""
    jcfg = reduced_config(JC.get_config("deepseek-v2-lite-16b"))
    cfg = _port_config(jcfg)
    model = T.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu", dtype=torch.float32)
    batch = _tensors(jax_lm_batch(jcfg, 2, 16, 0))
    out = {}
    for remat in (False, True):
        c = replace(cfg, remat=remat)
        out[remat] = loss_and_grads(lambda m, b: T.loss_fn(c, m, b), model,
                                    batch)
    assert float(out[True][0]) == pytest.approx(float(out[False][0]),
                                                rel=1e-6)
    for k, g in out[False][2].items():
        torch.testing.assert_close(out[True][2][k], g, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", ["dlrm-rm2", "deepfm", "sasrec",
                                  "bert4rec"])
def test_recsys_loss_gradients_match_jax_grad(arch):
    """``recsys.loss_fn``: the dense table gradient (every row, zero where
    no id landed), DLRM's through kernel 4's plain forward and its
    backward, the MLPs, the sequential encoders."""
    jcfg = reduced_config(JC.get_config(arch))
    cfg = _port_config(jcfg)
    params = JR.init_params(jcfg, jax.random.PRNGKey(2))
    model = R.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    batch = jax_recsys_batch(jcfg, 64, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, _), jg = jax.value_and_grad(
        lambda p: JR.loss_fn(jcfg, p, jb), has_aux=True)(params)
    loss, _, grads = loss_and_grads(lambda m, b: R.loss_fn(cfg, m, b), model,
                                    _tensors(batch))
    np.testing.assert_allclose(float(loss), float(want), **TOL)
    _hold_grads(model, grads, jg)


def _gin(learnable):
    jcfg = JC.replace(JC.get_config("gin-tu"), learnable_eps=learnable)
    cfg = _port_config(jcfg)
    params = JG.init_gin(jcfg, jax.random.PRNGKey(3), 32, 8)
    # a nonzero eps, so that its gradient (or its absence) shows
    params["layers"][0]["eps"] = jnp.float32(0.25)
    model = G.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return jcfg, cfg, params, model


@pytest.mark.parametrize("learnable", [True, False],
                         ids=["learnable_eps", "fixed_eps"])
@pytest.mark.parametrize("which", ["node_loss", "graph_loss"])
def test_gnn_loss_gradients_match_jax_grad(which, learnable):
    """``gnn.node_loss`` and ``graph_loss``: ``eps`` has a gradient only
    under ``learnable_eps`` (the reference's ``stop_gradient``)."""
    jcfg, cfg, params, model = _gin(learnable)
    g = jax_graph(200, 800, 32, 8, seed=4)
    if which == "graph_loss":
        g = dict(g, graph_id=(np.arange(200) // 25).astype(np.int32),
                 labels=np.arange(8, dtype=np.int32) % 8)
        g.pop("label_mask")
    jb = {k: jnp.asarray(v) for k, v in g.items()}
    jfn, tfn = getattr(JG, which), getattr(G, which)
    (want, _), jg = jax.value_and_grad(
        lambda p: jfn(jcfg, p, jb), has_aux=True)(params)
    loss, _, grads = loss_and_grads(lambda m, b: tfn(cfg, m, b), model,
                                    _tensors(g))
    np.testing.assert_allclose(float(loss), float(want), **TOL)
    _hold_grads(model, grads, jg)
    eps_grad = float(grads["layers.0.eps"])
    assert (eps_grad != 0.0) == learnable


# ---------------------------------------------------------------------------
# kernel 4's backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(5, 27, 64), (3, 4, 16), (1, 2, 8)])
def test_dot_interaction_grad_ref_matches_jax_grad(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    p = shape[1] * (shape[1] - 1) // 2
    w = rng.standard_normal((shape[0], p)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(JK.dot_interaction_ref(a) * w))(
        jnp.asarray(x))
    got = ref.dot_interaction_grad_ref(torch.from_numpy(x),
                                       torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dot_interaction_gradcheck_in_float64():
    x = torch.randn((3, 6, 5), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    assert torch.autograd.gradcheck(ops.DotInteraction.apply, (x,))
    assert torch.autograd.gradcheck(ops.dot_interaction, (x,))


def test_autograd_through_the_plain_forward_equals_grad_ref():
    """The plain forward writes chunks into a preallocated output; autograd
    through it gives ``dot_interaction_grad_ref``'s gradient."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((7, 9, 12), generator=gen, requires_grad=True)
    w = torch.randn((7, 36), generator=gen)
    out = ref.dot_interaction_ref(x, chunk_bytes=3 * 4 * 81)   # 3 a chunk
    gx, = torch.autograd.grad(torch.sum(out * w), x)
    torch.testing.assert_close(gx, ref.dot_interaction_grad_ref(
        x.detach(), w, chunk_bytes=2 * 4 * 12 * 9), rtol=1e-5, atol=1e-6)
    assert ref.dot_interaction_grad_ref(
        x.detach().to(torch.bfloat16), w).dtype == torch.bfloat16


def test_kernel_4_under_autograd_counts_forward_launches_only(monkeypatch):
    """On a CUDA tensor the forward is the kernel (one count a call) and
    the backward the plain gradient (no count); served without a graph,
    the call skips the autograd Function."""
    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(DI, "dot_interaction_cuda", ref.dot_interaction_ref)
    applied = []
    real = ops.DotInteraction.apply
    monkeypatch.setattr(ops.DotInteraction, "apply",
                        lambda x: applied.append(1) or real(x))
    ops.reset_launches()
    x = torch.randn((4, 5, 8), requires_grad=True)
    y = ops.dot_interaction(x)
    torch.sum(y * y).backward()
    assert ops.LAUNCHES["dot_interaction"] == 1 and applied == [1]
    with torch.no_grad():
        ops.dot_interaction(x)
    ops.dot_interaction(x.detach())
    assert ops.LAUNCHES["dot_interaction"] == 3 and applied == [1]
    ops.reset_launches()


def test_reference_cannot_differentiate_its_pallas_kernel_4():
    """A pinned fact: ``pallas_call`` has no reverse-mode rule and the
    reference defines no ``custom_vjp``, so ``jax.grad`` through kernel 4
    (here in interpret mode) raises; through its plain version it works."""
    x = jnp.asarray(np.random.default_rng(0).standard_normal((4, 27, 64)),
                    jnp.float32)
    with pytest.raises(Exception, match="Linearization failed|"
                                        "not implemented|JVP"):
        jax.grad(lambda a: JO.dot_interaction(
            a, backend="interpret").sum())(x)
    g = jax.grad(lambda a: JO.dot_interaction(a, backend="xla").sum())(x)
    assert np.isfinite(np.asarray(g)).all()


def test_dlrm_training_input_equals_the_served_one():
    """The loss path builds the interaction input by concatenation (autograd
    refuses ``index_select(out=)``); its values are the served path's."""
    cfg = replace(get_config("dlrm-rm2"), vocab_per_field=100)
    model = R.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    from repro_torch.data import recsys_batch
    b = R.as_batch(recsys_batch(cfg, 32, 0), "cpu")
    dense_t, x_t = R.interaction_input(cfg, model, b)
    assert x_t.requires_grad
    with torch.no_grad():
        dense_s, x_s = R.interaction_input(cfg, model, b)
    assert torch.equal(x_t.detach(), x_s) and torch.equal(dense_t.detach(),
                                                          dense_s)
    served = R.serve_fn(cfg, model, b)
    assert not served.requires_grad
    logits = R.dlrm_logits(cfg, model, b)
    torch.testing.assert_close(torch.sigmoid(logits).detach(), served,
                               rtol=0, atol=0)
