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
    w, i = ops.level_step(_t(masks), _t(_pad_t(packed)),
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


def test_level_step_refuses_unpadded_artifact():
    """level_step never pads its big operand: a raw (V, W) transpose is an
    error, not a silent per-call pad."""
    packed, masks, terms, valid, visited = _level_inputs(4, 33, 3, 0)
    with pytest.raises(ValueError, match="pre-padded"):
        ops.level_step(_t(masks), _t(np.ascontiguousarray(packed.T)),
                       torch.from_numpy(terms), torch.from_numpy(valid),
                       torch.from_numpy(visited), v=33, k=4)


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
