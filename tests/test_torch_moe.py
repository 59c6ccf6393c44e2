"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
reference's, on the CPU.

Expert weights come from the reference's ``init_moe_params`` under a
``jax.random`` key, as numpy, copied into the port's ``MoE`` module;
tokens from numpy seeds.  ``_position_in_expert`` is held exactly; the FFN
output and its aux loss at fp32 rtol = atol = 1e-4 (the same products in
another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as JM  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.layers import assign_from_reference  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def pair_moe(seed, d, ff, e, n_shared):
    params = jax.tree.map(np.asarray, JM.init_moe_params(
        jax.random.PRNGKey(seed), d, ff, e, n_shared, jnp.float32))
    model = M.MoE(d, ff, e, n_shared, dtype=torch.float32, device="cpu")
    assign_from_reference(model, params)
    return jax.tree.map(jnp.asarray, params), model


@pytest.mark.parametrize("n,e,seed", [(1, 1, 0), (50, 4, 1), (300, 8, 2),
                                      (97, 64, 3)])
def test_position_in_expert_is_exact(n, e, seed):
    flat = np.random.default_rng(seed).integers(0, e, n).astype(np.int32)
    want = np.asarray(JM._position_in_expert(jnp.asarray(flat), e))
    got = M._position_in_expert(torch.from_numpy(flat).long(), e)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    for x in range(e):                 # each expert's entries count 0, 1, ..
        np.testing.assert_array_equal(np.sort(want[flat == x]),
                                      np.arange((flat == x).sum()))


@pytest.mark.parametrize("cf,n_shared", [(1.25, 0), (0.5, 0), (0.5, 2),
                                         (2.0, 1)])
def test_moe_ffn_matches_reference(cf, n_shared):
    """capacity_factor 0.5 drops tokens past capacity (GShard), 2.0 keeps
    every one; shared experts add the dense branch; the aux loss."""
    t, d, ff, e, k = 64, 16, 32, 8, 2
    jparams, model = pair_moe(4, d, ff, e, n_shared)
    x = np.random.default_rng(5).standard_normal((t, d)).astype(np.float32)
    want, jaux = JM.moe_ffn(jparams, jnp.asarray(x), top_k=k,
                            capacity_factor=cf, router_aux_weight=0.01)
    got, aux = M.moe_ffn(model, torch.from_numpy(x), top_k=k,
                         capacity_factor=cf, router_aux_weight=0.01)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    if cf < 1:                         # some tokens were dropped
        full, _ = M.moe_ffn(model, torch.from_numpy(x), top_k=k,
                            capacity_factor=e / k, router_aux_weight=0.01)
        assert not torch.allclose(got, full)


def test_router_ties_go_to_the_lower_expert():
    """Identical router columns give equal probabilities: ``lax.top_k``
    takes the lower expert first, and so does the port."""
    t, d, ff, e, k = 12, 8, 16, 6, 3
    jparams, model = pair_moe(6, d, ff, e, 0)
    router = np.array(jparams["router"])
    router[:, 3] = router[:, 1]
    router[:, 5] = router[:, 1]
    jparams["router"] = jnp.asarray(router)
    with torch.no_grad():
        model.router.copy_(torch.from_numpy(router))
    x = np.random.default_rng(7).standard_normal((t, d)).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(x) @ model.router, -1)
    _, idx = M._top_k(probs, k)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.detach().numpy()), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    for cf in (1.0, e / k):
        want, _ = JM.moe_ffn(jparams, jnp.asarray(x), top_k=k,
                             capacity_factor=cf, router_aux_weight=0.01)
        got, _ = M.moe_ffn(model, torch.from_numpy(x), top_k=k,
                           capacity_factor=cf, router_aux_weight=0.01)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t", [1, 8, 9])
def test_inference_capacity_keeps_every_token(t):
    """At inference the capacity factor is E / k (64 / 6 is not exact in
    floating point): the capacity is computed in the reference's float
    arithmetic, and no token is dropped."""
    d, ff, e, k = 8, 16, 64, 6
    jparams, model = pair_moe(8, d, ff, e, 1)
    x = np.random.default_rng(t).standard_normal((t, d)).astype(np.float32)
    cf = float(e) / k
    want, _ = JM.moe_ffn(jparams, jnp.asarray(x), top_k=k,
                         capacity_factor=cf, router_aux_weight=0.0)
    got, _ = M.moe_ffn(model, torch.from_numpy(x), top_k=k,
                       capacity_factor=cf, router_aux_weight=0.0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    # every token alone gives its own row: nothing was dropped
    for i in range(t):
        one, _ = M.moe_ffn(model, torch.from_numpy(x[i:i + 1]), top_k=k,
                           capacity_factor=cf, router_aux_weight=0.0)
        np.testing.assert_allclose(one[0].detach().numpy(), got[i].detach().numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_init_moe_params_draw_like_the_reference():
    d, ff, e = 64, 96, 8
    model = M.init_moe_params(torch.Generator().manual_seed(0), d, ff, e, 2,
                              torch.bfloat16, device="cpu")
    ref = JM.init_moe_params(jax.random.PRNGKey(0), d, ff, e, 2, jnp.bfloat16)
    got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in model.named_parameters()}
    assert got == {n: (tuple(v.shape), str(v.dtype)) for n, v in ref.items()}
    assert model.router.dtype == torch.float32
    for name, p in model.named_parameters():
        fan_in = p.shape[-2]
        assert abs(float(p.float().std()) * fan_in ** 0.5 - 1) < 0.1, name
    assert not M.MoE(d, ff, e, 0, dtype=torch.float32,
                     device="cpu").n_shared
