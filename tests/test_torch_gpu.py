"""The port's hand-written CUDA kernels against their plain versions, on
the card.  Every test here needs a CUDA device and skips without one; the
file imports no jax, so it runs on a GPU host that has none:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import QueryContext, QuerySpec, construct  # noqa: E402
from repro_torch.core.inverted_index import from_uint32  # noqa: E402
from repro_torch.core.query_context import pad_transposed  # noqa: E402
from repro_torch.data import synthetic_csl  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _bits(rng, shape, device, density=0.5):
    """Random uint32 words as int32 bit patterns; ``density`` < 1 zeroes
    whole words (sparse frontier masks)."""
    a = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    a[rng.random(shape) >= density] = 0
    return from_uint32(a, device)


@pytest.mark.gpu
@pytest.mark.parametrize("b,w,v", [
    (1, 1, 9), (37, 70, 515), (256, 300, 2049), (33, 129, 256)])
def test_postings_kernel_matches_plain(cuda, b, w, v):
    rng = np.random.default_rng(b + w + v)
    masks = _bits(rng, (b, w), cuda, density=0.7)
    packed = _bits(rng, (w, v), cuda)
    before = ops.LAUNCHES["postings_counts"]
    got = ops.postings_counts(masks, packed)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["postings_counts"] == before + 1
    assert torch.equal(got, ref.postings_counts_ref(masks, packed))


@pytest.mark.gpu
@pytest.mark.parametrize("q,b,v,w,k,dedup", [
    (1, 5, 97, 7, 6, True),        # ragged, pad columns
    (1, 3, 40, 3, 50, False),      # k > V, dedup off
    (4, 16, 1000, 130, 16, True),  # batch-major, several V tiles
    (2, 8, 300, 40, 200, True),    # k above the 128-column tile
])
def test_level_step_kernel_matches_plain(cuda, q, b, v, w, k, dedup):
    rng = np.random.default_rng(q * b * v)
    r = q * b
    packed = _bits(rng, (w, v), cuda)
    masks = _bits(rng, (r, w), cuda, density=0.8)
    terms = torch.from_numpy(rng.integers(-1, v, r)).to(cuda)
    valid = torch.from_numpy(rng.integers(0, 2, r).astype(bool)).to(cuda)
    visited = torch.from_numpy(rng.integers(0, 2, (q, v)).astype(bool)).to(cuda)
    pt = pad_transposed(packed)
    before = ops.LAUNCHES["level_step"]
    got_w, got_i = ops.level_step(masks, pt, terms, valid, visited, v=v, k=k,
                                  dedup=dedup)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["level_step"] == before + 1
    k_eff = min(k, v)
    want_w, want_i = ref.level_step_ref(masks, pt, terms, valid, visited,
                                        v=v, k=k_eff, dedup=dedup)
    assert torch.equal(got_w[:, :k_eff], want_w)
    assert torch.equal(got_i[:, :k_eff], want_i)
    assert (got_w[:, k_eff:] == -1).all() and (got_i[:, k_eff:] == 0).all()


@pytest.mark.gpu
def test_kernel_wrappers_refuse_bad_operands(cuda):
    m = torch.zeros((2, 3), dtype=torch.int64, device=cuda)
    p = torch.zeros((3, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ops.postings_counts(m, p)
    with pytest.raises(ValueError):
        ops.postings_counts(p[:, :2].to(torch.int32), p.cpu())


@pytest.mark.gpu
def test_bfs_methods_agree_on_the_card(cuda):
    """All four count methods give the same networks through construct on
    the card, scoped and unscoped."""
    docs = synthetic_csl(3000, 512, seed=3)
    ctx = QueryContext.from_docs(docs, 512, device=cuda)
    ctx.tag_scope("half", np.arange(0, 3000, 2))
    for scope in (None, "half"):
        nets = {}
        for method in ("gemm", "popcount", "pallas", "fused"):
            res = construct(ctx, QuerySpec(seeds=(0, 17), depth=3, topk=8,
                                           beam=16, method=method,
                                           scope=scope))
            nets[method] = torch.stack([res.network.src, res.network.dst,
                                        res.network.weight,
                                        res.network.valid.to(torch.int32)])
        for method in ("popcount", "pallas", "fused"):
            assert torch.equal(nets[method], nets["gemm"]), (method, scope)
