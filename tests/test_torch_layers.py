"""The port's shared layers (``repro_torch.models.layers``) and the plain
decode attention (``repro_torch.kernels.ops.decode_attn``) against the JAX
reference's, on the CPU.

Inputs come from numpy seeds and go through both packages.  Tolerances:
fp32 at rtol = atol = 1e-4 (the same arithmetic, summed in another
order); bf16 outputs at rtol = atol = 2^-7, one bf16 ulp (8 bits) of
either package's final rounding, since the products accumulate in fp32
in both and only the last cast rounds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as JO  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2 ** -7, atol=2 ** -7)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def pair(rng, shape, dtype="float32", scale=1.0):
    """One draw as (torch, jax) arrays of ``dtype``, rounded once."""
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    t, j = DTYPES[dtype]
    return torch.from_numpy(a).to(t), jnp.asarray(a).astype(j)


def close(got, want, tol=F32):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x, jx = pair(rng, (3, 5, 64), dtype, scale=3.0)
    g, jg = pair(rng, (64,), dtype)
    got = L.rmsnorm(x, g, 1e-6)
    assert got.dtype == x.dtype
    close(got, JL.rmsnorm(jx, jg, 1e-6), F32 if dtype == "float32" else BF16)


def test_rope_freqs():
    for dim, theta in ((64, 10000.0), (128, 500000.0), (8, 1e6)):
        close(L.rope_freqs(dim, theta, "cpu"), JL.rope_freqs(dim, theta),
              dict(rtol=1e-6, atol=0))


@pytest.mark.parametrize("layout", ["3d", "4d"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(layout, dtype):
    """Halves, not interleaved pairs; positions (1, S) as in prefill and
    (B, 1) as in decode, large ones included."""
    rng = np.random.default_rng(1)
    shape = (2, 6, 16) if layout == "3d" else (2, 6, 3, 16)
    x, jx = pair(rng, shape, dtype)
    tol = F32 if dtype == "float32" else BF16
    for pos in (np.arange(6)[None, :], np.array([[5], [70000]]),
                np.array([[0, 3, 9, 100, 1000, 524287]])):
        p = pos.astype(np.int32)
        got = L.apply_rope(x, torch.from_numpy(p), 500000.0)
        assert got.dtype == x.dtype and got.shape == x.shape
        close(got, JL.apply_rope(jx, jnp.asarray(p), 500000.0), tol)
    # the position 0 rotation is the identity
    zero = torch.zeros((1, 6), dtype=torch.int32)
    assert torch.equal(L.apply_rope(x, zero, 10000.0), x)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_attention(causal, g):
    rng = np.random.default_rng(g + 10 * causal)
    hkv = 2
    q, jq = pair(rng, (2, 9, hkv * g, 16))
    k, jk = pair(rng, (2, 9, hkv, 16))
    v, jv = pair(rng, (2, 9, hkv, 16))
    got = L.attention(q, k, v, causal=causal)
    assert got.shape == (2, 9, hkv * g, 16)
    close(got, JL.attention(jq, jk, jv, causal=causal))


def test_chunked_attention_matches_full_and_the_reference():
    """q_chunk splits the queries as the reference's scan does; a chunk
    that does not divide Sq falls back to the full path, as there."""
    rng = np.random.default_rng(3)
    q, jq = pair(rng, (2, 64, 8, 32))
    k, jk = pair(rng, (2, 64, 2, 32))
    v, jv = pair(rng, (2, 64, 2, 32))
    full = L.attention(q, k, v, causal=True, q_chunk=0)
    for chunk in (16, 64, 24):
        got = L.attention(q, k, v, causal=True, q_chunk=chunk)
        np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5,
                                   atol=1e-5)
        close(got, JL.attention(jq, jk, jv, causal=True, q_chunk=chunk))


def test_attention_q_offset_dv_and_scale():
    """Queries at an offset into the keys (the last 4 of 12 positions),
    values wider than the keys (MLA: dv != dh), an explicit scale."""
    rng = np.random.default_rng(4)
    q, jq = pair(rng, (1, 4, 4, 24))
    k, jk = pair(rng, (1, 12, 4, 24))
    v, jv = pair(rng, (1, 12, 4, 40))
    for chunk in (0, 2):
        got = L.attention(q, k, v, causal=True, q_chunk=chunk, q_offset=8,
                          scale=0.3)
        assert got.shape == (1, 4, 4, 40)
        close(got, JL.attention(jq, jk, jv, causal=True, q_chunk=chunk,
                                q_offset=8, scale=0.3))
    # offset 8: the first query sees 9 keys, not 1
    assert not torch.allclose(
        got, L.attention(q, k, v, causal=True, q_chunk=2, scale=0.3))


def test_attention_bf16():
    rng = np.random.default_rng(5)
    q, jq = pair(rng, (2, 8, 4, 32), "bfloat16")
    k, jk = pair(rng, (2, 8, 2, 32), "bfloat16")
    v, jv = pair(rng, (2, 8, 2, 32), "bfloat16")
    got = L.attention(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    close(got, JL.attention(jq, jk, jv, causal=True), BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu(dtype):
    rng = np.random.default_rng(6)
    x, jx = pair(rng, (3, 4, 32), dtype)
    w1, jw1 = pair(rng, (32, 48), dtype, scale=32 ** -0.5)
    w3, jw3 = pair(rng, (32, 48), dtype, scale=32 ** -0.5)
    w2, jw2 = pair(rng, (48, 32), dtype, scale=48 ** -0.5)
    got = L.swiglu(x, w1, w3, w2)
    assert got.dtype == x.dtype
    close(got, JL.swiglu(jx, jw1, jw3, jw2),
          F32 if dtype == "float32" else dict(rtol=2 ** -6, atol=2 ** -6))


def test_mm_promotes_as_jax_does():
    x = torch.ones((2, 3), dtype=torch.bfloat16)
    w = torch.full((3, 4), 0.5, dtype=torch.float32)
    assert L.mm(x, w).dtype == torch.float32
    assert L.mm(x, w.to(torch.bfloat16)).dtype == torch.bfloat16
    assert jnp.einsum("ab,bc->ac", jnp.ones((2, 3), jnp.bfloat16),
                      jnp.ones((3, 4), jnp.float32)).dtype == jnp.float32


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


def _decode_case(rng, b, hq, hkv, d, dv, s, q_dtype="float32",
                 cache_dtype="float32"):
    q = pair(rng, (b, hq, d), q_dtype)
    kc = pair(rng, (b, s, hkv, d), cache_dtype)
    vc = pair(rng, (b, s, hkv, dv), cache_dtype)
    kn = pair(rng, (b, hkv, d), cache_dtype)
    vn = pair(rng, (b, hkv, dv), cache_dtype)
    return q, kc, vc, kn, vn


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (8, 1)])
def test_decode_attn_gqa_every_length(hq, hkv):
    """Lengths 0..S in one batch: 0 attends to the current token alone,
    S to the whole cache and the token."""
    rng = np.random.default_rng(hq + hkv)
    s = 7
    b = s + 1
    (q, jq), (kc, jkc), (vc, jvc), (kn, jkn), (vn, jvn) = _decode_case(
        rng, b, hq, hkv, 16, 16, s)
    length = np.arange(s + 1, dtype=np.int32)
    got = ops.decode_attn(q, kc, vc, torch.from_numpy(length), kn, vn)
    assert got.shape == (b, hq, 16) and got.dtype == torch.float32
    close(got, JO.decode_attn(jq, jkc, jvc, jnp.asarray(length), jkn, jvn))
    # length 0: the output is the current token's value
    np.testing.assert_allclose(
        got[0].numpy(), torch.repeat_interleave(vn[0], hq // hkv, 0).numpy(),
        rtol=1e-6, atol=1e-6)


def test_decode_attn_mla_shape():
    """The MLA decode: one cache head serving as keys and values (d = dv =
    r + dr), every query head in one group."""
    rng = np.random.default_rng(20)
    b, h, cw, s = 3, 4, 40, 9
    (q, jq), (kc, jkc), _, (kn, jkn), _ = _decode_case(rng, b, h, 1, cw, cw,
                                                       s)
    length = np.array([0, 5, 9], np.int32)
    got = ops.decode_attn(q, kc, kc, torch.from_numpy(length), kn, kn)
    close(got, JO.decode_attn(jq, jkc, jkc, jnp.asarray(length), jkn, jkn))


def test_decode_attn_bf16_query_fp32_cache():
    """The server's case: bf16 queries against the fp32 cache; the output
    in the query's dtype."""
    rng = np.random.default_rng(21)
    (q, jq), (kc, jkc), (vc, jvc), (kn, jkn), (vn, jvn) = _decode_case(
        rng, 4, 8, 2, 32, 32, 11, q_dtype="bfloat16")
    length = np.array([0, 1, 6, 11], np.int32)
    got = ops.decode_attn(q, kc, vc, torch.from_numpy(length), kn, vn)
    assert got.dtype == torch.bfloat16
    close(got, JO.decode_attn(jq, jkc, jvc, jnp.asarray(length), jkn, jvn),
          BF16)


def test_decode_attn_bf16_cache():
    """A bf16 cache (prefill's own): the cache weights are cast to bf16
    once, as the reference casts them."""
    rng = np.random.default_rng(22)
    (q, jq), (kc, jkc), (vc, jvc), (kn, jkn), (vn, jvn) = _decode_case(
        rng, 2, 4, 2, 16, 16, 5, q_dtype="bfloat16", cache_dtype="bfloat16")
    length = np.array([3, 5], np.int32)
    got = ops.decode_attn(q, kc, vc, torch.from_numpy(length), kn, vn)
    close(got, JO.decode_attn(jq, jkc, jvc, jnp.asarray(length), jkn, jvn),
          BF16)


def test_decode_attn_counts_no_launch():
    """Plain PyTorch on every device: none of the five kernels."""
    rng = np.random.default_rng(23)
    (q, _), (kc, _), (vc, _), (kn, _), (vn, _) = _decode_case(
        rng, 2, 4, 2, 8, 8, 3)
    before = dict(ops.LAUNCHES)
    ops.decode_attn(q, kc, vc, torch.tensor([1, 3]), kn, vn)
    assert ops.LAUNCHES == before


def test_rope_freqs_runs_on_the_card_unless_asked():
    """Like every entry point of the port: no card and no ``device="cpu"``
    raises, where it once made a CPU tensor on a GPU host."""
    if torch.cuda.is_available():
        assert L.rope_freqs(64, 1e4).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            L.rope_freqs(64, 1e4)
    assert L.rope_freqs(64, 1e4, device="cpu").device.type == "cpu"
