"""The port's LM (``repro_torch.models.transformer``) against the JAX
reference's, on the CPU.

Every arch runs at the reference's ``reduced_config`` (2 layers, d 128, a
512-token vocabulary; the MoE archs 4 experts top-2, deepseek's MLA at
rank 32).  Weights come from the reference's ``init_params`` under a
``jax.random`` key, as numpy, carried across by ``params_from_reference``;
qwen's QKV biases are set to nonzero values in that pytree first, so they
count.  Tokens come from numpy seeds.

Tolerances: fp32 logits, hidden states and caches at rtol = atol = 1e-4
(the same products summed in another order); bf16 weights at 2^-5 of the
logits' largest magnitude: bf16 keeps 8 bits, the port rounds every op's
output to bf16 while XLA keeps some of a fusion's intermediates in fp32,
so the two hidden states part by a few ulps (2^-8) a layer.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.launch.train import reduced_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

LM_ARCHS = ["llama3-8b", "granite-3-8b", "qwen1.5-32b",
            "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def port_config(jcfg):
    """The port's config with every field of the reference's ``jcfg``."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
              if f.name != "shapes"}
    return TC.replace(TC.get_config(jcfg.name), **fields)


def reference_model(arch, seed=1, dtype=jnp.float32, **overrides):
    """(port cfg, reference cfg, reference params (jnp), port model)."""
    jcfg = reduced_config(JC.get_config(arch))
    if overrides:
        jcfg = JC.replace(jcfg, **overrides)
    params = jax.tree.map(np.asarray,
                          JT.init_params(jcfg, jax.random.PRNGKey(seed),
                                         dtype=dtype))
    if jcfg.qkv_bias:                  # nonzero biases, so that they count
        rng = np.random.default_rng(seed)
        attn = params["dense_layers"]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = (0.5 * rng.standard_normal(attn[name].shape)
                          ).astype(attn[name].dtype)
    cfg = port_config(jcfg)
    model = T.params_from_reference(cfg, params, device="cpu")
    return cfg, jcfg, jax.tree.map(jnp.asarray, params), model


def tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want,
                                                               np.float32),
                               **tol)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill into a padded cache, then three greedy decode steps: the
    logits, the whole cache and the lengths at each step."""
    cfg, jcfg, jparams, model = reference_model(arch)
    toks = tokens(cfg, (2, 7))
    want, jcache = JT.prefill(jcfg, jparams, jnp.asarray(toks), max_len=12)
    got, cache = T.prefill(cfg, model, torch.from_numpy(toks), max_len=12)
    assert got.shape == (2, cfg.padded_vocab) and got.dtype == torch.float32
    close(got, want)
    close(cache["kv"], jcache["kv"])
    assert cache["kv"].shape == jcache["kv"].shape
    assert cache["length"].tolist() == [7, 7]
    for _ in range(3):
        nxt = np.array(jnp.argmax(want, axis=-1), np.int32)
        want, jcache = JT.decode_step(jcfg, jparams, jcache, jnp.asarray(nxt))
        got, cache = T.decode_step(cfg, model, cache, torch.from_numpy(nxt))
        close(got, want)
        close(cache["kv"], jcache["kv"])
        assert cache["length"].tolist() == np.asarray(
            jcache["length"]).tolist()
        assert cache["length"].dtype == torch.int32


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_reference_training_routing(arch):
    """``forward`` without a cache: training routing (capacity_factor 1.25,
    overflow dropped), the hidden states, the aux loss and the logits."""
    cfg, jcfg, jparams, model = reference_model(arch, seed=2)
    toks = tokens(cfg, (2, 16), seed=3)
    h_want, aux_want, _ = JT.forward(jcfg, jparams, jnp.asarray(toks))
    h, aux, caches = T.forward(cfg, model, torch.from_numpy(toks))
    assert caches == (None, None)
    close(h, h_want)
    np.testing.assert_allclose(float(aux), float(aux_want), **TOL)
    if not cfg.moe:
        assert float(aux) == 0.0
    close(T.logits_for(cfg, model, h), JT.logits_for(jcfg, jparams, h_want))


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-lite-16b"])
def test_out_of_range_cache_write_is_dropped(arch):
    """The reference's own smoke test prefills 8 tokens with no max_len
    and then decodes: the write at position 8 of an 8-position cache is
    dropped.  The port drops exactly that row and no other."""
    cfg, jcfg, jparams, model = reference_model(arch, seed=4)
    toks = tokens(cfg, (2, 8), seed=5)
    want, jcache = JT.prefill(jcfg, jparams, jnp.asarray(toks))
    got, cache = T.prefill(cfg, model, torch.from_numpy(toks))
    before = cache["kv"].clone()
    nxt = np.array(jnp.argmax(want, axis=-1), np.int32)
    want2, jcache2 = JT.decode_step(jcfg, jparams, jcache, jnp.asarray(nxt))
    got2, cache2 = T.decode_step(cfg, model, cache, torch.from_numpy(nxt))
    assert torch.equal(cache2["kv"], before)
    np.testing.assert_array_equal(np.asarray(jcache2["kv"]),
                                  np.asarray(jcache["kv"]))
    assert cache2["length"].tolist() == [9, 9]
    close(got2, want2)
    # a batch of one row in range and one past it: only the first writes
    cache3 = {"kv": before.clone(),
              "length": torch.tensor([3, 8], dtype=torch.int32)}
    jcache3 = {"kv": jnp.asarray(before.numpy()),
               "length": jnp.asarray([3, 8], jnp.int32)}
    want3, jcache3 = JT.decode_step(jcfg, jparams, jcache3, jnp.asarray(nxt))
    got3, cache3 = T.decode_step(cfg, model, cache3, torch.from_numpy(nxt))
    close(got3, want3)
    close(cache3["kv"], jcache3["kv"])
    assert torch.equal(cache3["kv"][:, 1], before[:, 1])
    assert not torch.equal(cache3["kv"][:, 0, 3], before[:, 0, 3])


@pytest.mark.parametrize("arch,n", [("llama3-8b", 4), ("qwen1.5-32b", 4),
                                    ("deepseek-v2-lite-16b", 3)])
def test_decode_matches_prefill(arch, n):
    """Teacher forcing: decode_step's logits at position i equal the
    logits of a prefill over the first i + 1 tokens (GQA and MLA, the
    reference's ``test_decode_matches_prefill_logits`` and
    ``test_mla_decode_matches_prefill`` on the port)."""
    cfg, _, _, model = reference_model(arch, seed=5)
    seq = torch.from_numpy(tokens(cfg, (1, 2 * n), seed=6))
    h, _, _ = T.forward(cfg, model, seq, inference=True)
    full = T.logits_for(cfg, model, h)                       # (1, 2n, Vp)
    logits, cache = T.prefill(cfg, model, seq[:, :n], max_len=2 * n)
    np.testing.assert_allclose(logits.numpy(), full[:, n - 1].detach().numpy(),
                               rtol=2e-4, atol=2e-4)
    for i in range(n, 2 * n):
        logits, cache = T.decode_step(cfg, model, cache, seq[:, i])
        np.testing.assert_allclose(logits.numpy(), full[:, i].detach().numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_tied_head_and_qkv_biases():
    """granite's head is its embedding (no ``lm_head``); qwen's biases
    move its logits, so the parity test above compares them."""
    cfg, jcfg, jparams, model = reference_model("granite-3-8b")
    assert cfg.tie_embeddings and "lm_head" not in jparams
    assert not hasattr(model, "lm_head")
    h = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, cfg.d_model)).astype(np.float32))
    assert torch.allclose(T.logits_for(cfg, model, h), h @ model.embed.t(),
                          rtol=1e-5, atol=1e-5)
    cfg, jcfg, jparams, model = reference_model("qwen1.5-32b")
    toks = torch.from_numpy(tokens(cfg, (1, 5)))
    with_bias, _ = T.prefill(cfg, model, toks)
    with torch.no_grad():
        for block in model.dense_layers:
            for name in ("bq", "bk", "bv"):
                assert float(getattr(block.attn, name).abs().max()) > 0
                getattr(block.attn, name).zero_()
    without, _ = T.prefill(cfg, model, toks)
    assert float((with_bias - without).abs().max()) > 1e-2


def test_padded_vocab_is_masked_like_the_reference():
    cfg, jcfg, jparams, model = reference_model("llama3-8b", vocab_size=500)
    assert cfg.padded_vocab == 512
    toks = tokens(cfg, (2, 4))
    want, _ = JT.prefill(jcfg, jparams, jnp.asarray(toks))
    got, _ = T.prefill(cfg, model, torch.from_numpy(toks))
    assert (got[:, 500:] == -1e30).all()
    close(got, want)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_params_have_the_references_weights(arch):
    """Every weight of the reference's pytree, by name, shape and dtype
    (the router fp32, the rest bf16), drawn N(0, 1) / sqrt(in), zero
    biases, unit norms; ``kv_cache_dims`` and ``init_cache`` agree."""
    cfg, jcfg, _, _ = reference_model(arch)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = T.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        keys = [p.key for p in path]
        if keys[0] in ("dense_layers", "moe_layers"):
            for i in range(leaf.shape[0]):
                want[".".join([keys[0], str(i)] + keys[1:])] = (
                    leaf.shape[1:], str(leaf.dtype))
        else:
            want[".".join(keys)] = (leaf.shape, str(leaf.dtype))
    got = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in model.named_parameters()}
    assert got == want
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("ln1", "ln2", "final_norm"):
            assert (p == 1).all()
        elif leaf in ("bq", "bk", "bv"):
            assert (p == 0).all()
        elif p.numel() >= 4096:
            fan_in = p.shape[-2]
            assert abs(float(p.float().std()) * fan_in ** 0.5 - 1) < 0.1, name
    assert T.kv_cache_dims(cfg) == JT.kv_cache_dims(jcfg)
    cache = T.init_cache(cfg, 3, 10, device="cpu")
    jcache = JT.init_cache(jcfg, 3, 10)
    assert cache["kv"].shape == jcache["kv"].shape
    assert cache["kv"].dtype == torch.bfloat16
    assert cache["length"].dtype == torch.int32
    again = T.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-lite-16b"])
def test_bf16_prefill_and_decode_match_reference(arch):
    """bf16 weights and a bf16 cache (prefill's own), as the reference
    serves them; within 2^-5 of the logits' largest magnitude."""
    cfg, jcfg, jparams, model = reference_model(arch, seed=7,
                                                dtype=jnp.bfloat16)
    assert model.embed.dtype == torch.bfloat16
    assert model.blocks()[-1].attn.wq.dtype == torch.bfloat16
    toks = tokens(cfg, (2, 6), seed=8)
    want, jcache = JT.prefill(jcfg, jparams, jnp.asarray(toks), max_len=8)
    got, cache = T.prefill(cfg, model, torch.from_numpy(toks), max_len=8)
    assert cache["kv"].dtype == torch.bfloat16
    for _ in range(2):
        scale = float(np.abs(np.asarray(want)).max())
        assert float((got - torch.from_numpy(np.array(want))).abs().max()
                     ) <= scale * 2 ** -5
        nxt = np.array(jnp.argmax(want, axis=-1), np.int32)
        want, jcache = JT.decode_step(jcfg, jparams, jcache, jnp.asarray(nxt))
        got, cache = T.decode_step(cfg, model, cache, torch.from_numpy(nxt))


def test_entry_points_refuse_the_cpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config(reduced_config(JC.get_config("llama3-8b")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_cache(cfg, 1, 4)
