"""The port's kernel wrappers against the JAX reference's.

On the CPU the port's ``ops.postings_counts`` / ``ops.level_step`` /
``ops.cooccur_counts`` run their plain versions
(``repro_torch.kernels.ref``); they must equal the reference's Pallas
kernels (interpret mode) and its XLA fallbacks exactly,
values and tie order, on inputs drawn with numpy from a fixed seed.  The
hand-written CUDA kernels are held against the plain versions in
``test_torch_gpu.py``, which needs a card and no jax.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.inverted_index import from_uint32  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from torch_operands import query_masks  # noqa: E402


def _t(a):
    """uint32 numpy -> the port's int32 bit-pattern tensor (CPU)."""
    return from_uint32(a, "cpu")


def _pad_t(packed):
    """(W, V) uint32 -> the reference's pre-padded (V->8, W->128) transpose."""
    w, v = packed.shape
    return np.pad(packed.T, ((0, (-v) % 8), (0, (-w) % 128)))


# ---------------------------------------------------------------------------
# popcount and postings counts
# ---------------------------------------------------------------------------


def test_popcount32_matches_bit_count():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 32, 4096, dtype=np.uint32)
    x[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    want = np.array([bin(int(a)).count("1") for a in x])
    np.testing.assert_array_equal(ref.popcount32(_t(x)).numpy(), want)


@pytest.mark.parametrize("b,w,v", [
    (8, 64, 128),      # tile-friendly
    (3, 33, 65),       # ragged everything
    (5, 7, 300),
    (1, 1, 9),         # single row, single word
])
@pytest.mark.parametrize("backend", ["interpret", "xla"])
def test_postings_counts_matches_reference(b, w, v, backend):
    rng = np.random.default_rng(b * w + v)
    masks = rng.integers(0, 1 << 32, (b, w), dtype=np.uint32)
    packed = rng.integers(0, 1 << 32, (w, v), dtype=np.uint32)
    want = np.asarray(jops.postings_counts(jnp.asarray(masks),
                                           jnp.asarray(packed),
                                           backend=backend))
    got = ops.postings_counts(_t(masks), _t(packed))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_postings_counts_chunking_is_exact():
    """A chunk budget of a single column gives the same counts."""
    rng = np.random.default_rng(4)
    masks = _t(rng.integers(0, 1 << 32, (6, 9), dtype=np.uint32))
    packed = _t(rng.integers(0, 1 << 32, (9, 70), dtype=np.uint32))
    whole = ref.postings_counts_ref(masks, packed)
    tiny = ref.postings_counts_ref(masks, packed, chunk_bytes=1)
    assert torch.equal(whole, tiny)


def test_postings_counts_sparse_bitmaps():
    """All-zero masks -> zero counts; all-ones (-1 words) -> column
    popcounts."""
    rng = np.random.default_rng(3)
    packed = rng.integers(0, 1 << 32, (32, 128), dtype=np.uint32)
    zeros = np.zeros((1, 32), np.uint32)
    ones = np.full((1, 32), 0xFFFFFFFF, np.uint32)
    assert (ops.postings_counts(_t(zeros), _t(packed)) == 0).all()
    colpc = np.array([sum(bin(int(x)).count("1") for x in packed[:, j])
                      for j in range(128)])
    np.testing.assert_array_equal(
        ops.postings_counts(_t(ones), _t(packed))[0].numpy(), colpc)


# ---------------------------------------------------------------------------
# fused level step
# ---------------------------------------------------------------------------


def _level_inputs(b, v, w, seed):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 1 << 32, (w, v), dtype=np.uint32)
    masks = rng.integers(0, 1 << 32, (b, w), dtype=np.uint32)
    terms = rng.integers(-1, v, (b,)).astype(np.int32)
    valid = rng.integers(0, 2, (b,)).astype(bool)
    visited = rng.integers(0, 2, (v,)).astype(bool)
    return packed, masks, terms, valid, visited


def _jax_level(masks, packed, terms, valid, visited, *, v, k, dedup, backend):
    w, i = jops.level_step(jnp.asarray(masks), jnp.asarray(_pad_t(packed)),
                           jnp.asarray(terms), jnp.asarray(valid),
                           jnp.asarray(visited), v=v, k=k, dedup=dedup,
                           backend=backend)
    return np.asarray(w), np.asarray(i)


def _port_level(masks, packed, terms, valid, visited, *, v, k, dedup):
    """The port's level step takes the index's (W, V) postings where the
    reference takes their padded transpose (``_pad_t``)."""
    w, i = ops.level_step(_t(masks), _t(packed),
                          torch.from_numpy(terms), torch.from_numpy(valid),
                          torch.from_numpy(visited), v=v, k=k, dedup=dedup)
    assert w.dtype == torch.int32 and i.dtype == torch.int32
    return w.numpy(), i.numpy()


@pytest.mark.parametrize("b,v,w,k,dedup", [
    (5, 97, 7, 6, True),       # ragged everything, pad columns
    (3, 40, 3, 50, False),     # k > V (clamp + pad), dedup off
    (8, 256, 4, 8, True),      # tile-friendly B/V
    (1, 9, 1, 9, True),        # single row, k == V
    (6, 130, 2, 3, False),     # W far below the 128-word padding
])
@pytest.mark.parametrize("backend", ["xla", "interpret"])
def test_level_step_matches_reference(b, v, w, k, dedup, backend):
    """Plain level step == the reference's, values AND tie order, with
    invalid rows (terms -1, valid False) and visited columns mixed in."""
    packed, masks, terms, valid, visited = _level_inputs(b, v, w, b * v)
    want = _jax_level(masks, packed, terms, valid, visited, v=v, k=k,
                      dedup=dedup, backend=backend)
    got = _port_level(masks, packed, terms, valid, visited, v=v, k=k,
                      dedup=dedup)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_level_step_forced_ties_take_lower_columns():
    """Identical postings columns tie every count: the order must be the
    lower column first, as lax.top_k orders ties."""
    rng = np.random.default_rng(11)
    col = rng.integers(0, 1 << 32, (3, 1), dtype=np.uint32)
    packed = np.repeat(col, 50, axis=1)                       # (3, 50)
    masks = rng.integers(0, 1 << 32, (4, 3), dtype=np.uint32)
    terms = np.array([7, -1, 0, 49], np.int32)
    valid = np.array([True, False, True, True])
    visited = np.zeros(50, bool)
    visited[[3, 10]] = True
    for dedup in (True, False):
        want = _jax_level(masks, packed, terms, valid, visited, v=50, k=12,
                          dedup=dedup, backend="xla")
        got = _port_level(masks, packed, terms, valid, visited, v=50, k=12,
                          dedup=dedup)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_level_step_refuses_packed_of_another_shape():
    """level_step takes the index's (W, V) postings: a bitmap whose W is
    not the masks' W (a transposed or padded artifact among them), or
    whose V is below v, is an error."""
    packed, masks, terms, valid, visited = _level_inputs(4, 33, 3, 0)
    rest = (torch.from_numpy(terms), torch.from_numpy(valid),
            torch.from_numpy(visited))
    for bad in (np.ascontiguousarray(packed.T), _pad_t(packed), packed[:2],
                np.ascontiguousarray(packed[:, :32])):
        with pytest.raises(ValueError, match="postings"):
            ops.level_step(_t(masks), _t(bad), *rest, v=33, k=4)


def test_level_step_pad_columns_stay_below_real_candidates():
    """Every real column masked to -1: the pad columns (at -2) must never
    be returned."""
    packed, masks, terms, _, _ = _level_inputs(2, 97, 7, 5)
    valid = np.ones(2, bool)
    visited = np.ones(97, bool)
    w, i = _port_level(masks, packed, terms, valid, visited, v=97, k=6,
                       dedup=True)
    assert i.max() < 97
    assert (w == -1).all()
    want = _jax_level(masks, packed, terms, valid, visited, v=97, k=6,
                      dedup=True, backend="interpret")
    np.testing.assert_array_equal(w, want[0])
    np.testing.assert_array_equal(i, want[1])


@pytest.mark.parametrize("dedup", [True, False])
def test_level_step_batch_major_equals_separate_queries(dedup):
    """Q queries in one batch-major call (visited (Q, V), row r belongs to
    query r // B) == Q separate reference calls."""
    q, b, v, w, k = 3, 4, 70, 5, 5
    rng = np.random.default_rng(21)
    packed = rng.integers(0, 1 << 32, (w, v), dtype=np.uint32)
    masks = rng.integers(0, 1 << 32, (q * b, w), dtype=np.uint32)
    terms = rng.integers(-1, v, (q * b,)).astype(np.int32)
    valid = rng.integers(0, 2, (q * b,)).astype(bool)
    visited = rng.integers(0, 2, (q, v)).astype(bool)
    got = _port_level(masks, packed, terms, valid, visited, v=v, k=k,
                      dedup=dedup)
    for j in range(q):
        rows = slice(j * b, (j + 1) * b)
        want = _jax_level(masks[rows], packed, terms[rows], valid[rows],
                          visited[j], v=v, k=k, dedup=dedup, backend="xla")
        np.testing.assert_array_equal(got[0][rows], want[0])
        np.testing.assert_array_equal(got[1][rows], want[1])


@pytest.mark.parametrize("frac,q,v,w,k", [
    (0.01, 3, 300, 500, 16),     # 1% of the words, the serving top-k
    (0.05, 2, 130, 300, 16),
    (0.05, 1, 600, 40, 300),     # k above the CUDA kernel's 256-column tile
    (0.01, 2, 257, 200, 257),    # k == V, one column past the tile
])
def test_level_step_on_query_masks_matches_reference(frac, q, v, w, k):
    """Frontier masks shaped like the BFS's (a query's rows nonzero only
    inside its seed support, ``torch_operands.query_masks``), 5 rows a query
    so that 4-row tiles straddle queries: the port == the reference."""
    rng = np.random.default_rng(int(frac * 100) + v)
    b = 5
    masks = query_masks(rng, q, b, w, frac)
    packed = rng.integers(0, 1 << 32, (w, v), dtype=np.uint32)
    terms = rng.integers(-1, v, (q * b,)).astype(np.int32)
    valid = rng.random(q * b) < 0.8
    visited = rng.random((q, v)) < 0.3
    got = _port_level(masks, packed, terms, valid, visited, v=v, k=k,
                      dedup=True)
    for j in range(q):                  # the reference takes one query
        rows = slice(j * b, (j + 1) * b)
        want = _jax_level(masks[rows], packed, terms[rows], valid[rows],
                          visited[j], v=v, k=k, dedup=True, backend="xla")
        np.testing.assert_array_equal(got[0][rows], want[0])
        np.testing.assert_array_equal(got[1][rows], want[1])


# ---------------------------------------------------------------------------
# co-occurrence counts
# ---------------------------------------------------------------------------


def _doc_major(a):
    """(D, V) 0/1 numpy -> the port's operand layout: the ``.t()`` view of
    term-major (V, D) int8 storage, doc axis contiguous."""
    return torch.from_numpy(np.ascontiguousarray(a.T, np.int8)).t()


@pytest.mark.parametrize("d,vl,vr", [
    (64, 32, 32), (512, 128, 128), (300, 200, 100), (1024, 128, 256),
    (33, 17, 9),                       # ragged everything
])
def test_cooccur_counts_match_reference(d, vl, vr):
    """int8 operands here, bf16 in the reference, the same 0/1 values:
    counts and the float32 product are identical."""
    rng = np.random.default_rng(d + vl)
    xl = (rng.random((d, vl)) < 0.15).astype(np.float32)
    xr = (rng.random((d, vr)) < 0.15).astype(np.float32)
    jl, jr = jnp.asarray(xl, jnp.bfloat16), jnp.asarray(xr, jnp.bfloat16)
    got = ops.cooccur_counts(_doc_major(xl), _doc_major(xr))
    assert got.dtype == torch.int32 and got.shape == (vl, vr)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.cooccur_counts(jl, jr,
                                                    backend="interpret")))
    gemm = ops.cooccur_gemm(_doc_major(xl), _doc_major(xr))
    assert gemm.dtype == torch.float32
    np.testing.assert_array_equal(
        gemm.numpy(), np.asarray(jops.cooccur_gemm(jl, jr, backend="interpret",
                                                   bm=32, bn=32, bk=64)))


def test_cooccur_counts_chunking_is_exact():
    """A chunk budget of a single column gives the same counts."""
    rng = np.random.default_rng(5)
    xl = _doc_major((rng.random((70, 6)) < 0.4).astype(np.int8))
    xr = _doc_major((rng.random((70, 45)) < 0.4).astype(np.int8))
    assert torch.equal(ref.cooccur_counts_ref(xl, xr),
                       ref.cooccur_counts_ref(xl, xr, chunk_bytes=1))


def test_cooccur_counts_refuse_a_copy_or_a_wrong_type():
    """The wrapper never copies: an operand whose doc axis is not
    contiguous is an error, as is a non-int8 operand or a doc mismatch."""
    x = _doc_major(np.ones((40, 8), np.int8))
    with pytest.raises(ValueError, match="contiguous"):
        ops.cooccur_counts(x.contiguous(), x)
    with pytest.raises(ValueError, match="contiguous"):
        ops.cooccur_counts(x, x.contiguous())
    with pytest.raises(TypeError, match="int8"):
        ops.cooccur_counts(x.to(torch.float32), x)
    with pytest.raises(ValueError, match="docs"):
        ops.cooccur_counts(x, x[:39])
    # one doc or one term: any stride of the unit axis is fine
    one = torch.ones((1, 5), dtype=torch.int8)
    assert (ops.cooccur_counts(one, one) == 1).all()


# ---------------------------------------------------------------------------
# DLRM dot interaction
# ---------------------------------------------------------------------------

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a, dtype):
    """One fp32 numpy array as the same values in both packages' dtype
    (both round to bf16 to nearest even)."""
    jdt, tdt = _DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


@pytest.mark.parametrize("b,f,e", [
    (128, 27, 64), (37, 27, 64), (64, 8, 16), (256, 40, 10),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_interaction_matches_reference(b, f, e, dtype):
    """The plain version == the Pallas kernel in interpret mode: fp32 at
    the reference's 1e-5; bf16 at 1e-2 (one bf16 step: only the final
    rounding of fp32 sums taken in another order differs)."""
    rng = np.random.default_rng(b + f)
    x = rng.standard_normal((b, f, e)).astype(np.float32)
    jx, tx = _both(x, dtype)
    want = np.asarray(jops.dot_interaction(jx, backend="interpret", bb=32),
                      np.float32)
    got = ops.dot_interaction(tx)
    assert got.dtype == tx.dtype and got.shape == (b, f * (f - 1) // 2)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_dot_interaction_pair_order():
    """Entry ordering matches (i, j) with i > j, row-major over i."""
    f, e = 4, 2
    x = np.arange(f * e, dtype=np.float32).reshape(1, f, e)
    got = ops.dot_interaction(torch.from_numpy(x)).numpy()
    gram = x[0] @ x[0].T
    want = [gram[1, 0], gram[2, 0], gram[2, 1], gram[3, 0], gram[3, 1],
            gram[3, 2]]
    np.testing.assert_allclose(got[0], want, rtol=1e-6)
    ref_out = np.asarray(jops.dot_interaction(jnp.asarray(x),
                                              backend="interpret", bb=1))
    np.testing.assert_allclose(got, ref_out, rtol=1e-6)


def test_dot_interaction_chunking_is_exact():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (9, 5, 3)).astype(np.float32))
    assert torch.equal(ref.dot_interaction_ref(x),
                       ref.dot_interaction_ref(x, chunk_bytes=1))


# ---------------------------------------------------------------------------
# flash decode
# ---------------------------------------------------------------------------


def _decode_case(b, hq, hkv, d, s, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


def _decode_both(q, k, v, length, chunk, dtype):
    jq, tq = _both(q, dtype)
    jk, tk = _both(k, dtype)
    jv, tv = _both(v, dtype)
    want = np.asarray(jops.flash_decode(jq, jk, jv, jnp.asarray(length),
                                        backend="interpret", chunk=chunk),
                      np.float32)
    got = ops.flash_decode(tq, tk, tv, torch.from_numpy(np.asarray(length)),
                           chunk=chunk)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    return got.float().numpy(), want


@pytest.mark.parametrize("b,hq,hkv,d,s,chunk", [
    (2, 8, 2, 64, 512, 128), (1, 4, 4, 32, 256, 64),
    (3, 16, 8, 128, 300, 128),          # ragged S (padding path)
    (2, 8, 1, 64, 1024, 256),           # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_matches_reference(b, hq, hkv, d, s, chunk, dtype):
    """The plain version == the Pallas kernel in interpret mode, at
    ``tests/test_kernels.py``'s shapes and tolerances (2e-5 / 2e-2)."""
    q, k, v = _decode_case(b, hq, hkv, d, s, b * s)
    length = np.random.default_rng(b * s).integers(1, s + 1, (b,)).astype(
        np.int32)
    got, want = _decode_both(q, k, v, length, chunk, dtype)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_length_one_and_zero(dtype):
    """Length 1 attends to v[0] alone; length 0 follows the Pallas
    kernel's arithmetic: every padded position weighs 1, so the row is
    sum(V[:S]) / S_pad (S = 300 padded to 384 by chunk 128)."""
    b, hq, hkv, d, s, chunk = 2, 4, 2, 32, 300, 128
    q, k, v = _decode_case(b, hq, hkv, d, s, 0)
    length = np.array([1, 0], np.int32)
    got, want = _decode_both(q, k, v, length, chunk, dtype)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    vb = _both(v, dtype)[1].float().numpy()
    g = hq // hkv
    np.testing.assert_allclose(got[0], np.repeat(vb[0, 0], g, axis=0),
                               rtol=tol, atol=tol)
    mean_pad = vb[1].sum(axis=0) / 384
    np.testing.assert_allclose(got[1], np.repeat(mean_pad, g, axis=0),
                               rtol=tol, atol=tol)


def test_flash_decode_chunking_is_exact():
    """Rows in chunks of one (a one-byte budget) give the same result."""
    q, k, v = (torch.from_numpy(a) for a in _decode_case(3, 4, 2, 16, 50, 4))
    ln = torch.tensor([0, 7, 50])
    assert torch.equal(ref.flash_decode_ref(q, k, v, ln, chunk=32),
                       ref.flash_decode_ref(q, k, v, ln, chunk=32,
                                            chunk_bytes=1))


def test_flash_decode_scalar_length_and_clamp():
    """A scalar length broadcasts over B; a length above S reads as S."""
    q, k, v = _decode_case(2, 4, 2, 16, 40, 3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    full = ops.flash_decode(tq, tk, tv, torch.tensor([40, 40]), chunk=16)
    assert torch.equal(ops.flash_decode(tq, tk, tv, 40, chunk=16), full)
    assert torch.equal(ops.flash_decode(tq, tk, tv, 99, chunk=16), full)
    with pytest.raises(ValueError):
        ops.flash_decode(tq, tk[:, :, :1].repeat(1, 1, 3, 1),
                         tv[:, :, :1].repeat(1, 1, 3, 1), 40)
