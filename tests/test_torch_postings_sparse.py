"""The arithmetic around the redesigned postings and decode kernels, on the
CPU: the postings kernel's compaction (``ref.active_words_ref``, the plain
version of its first launch) against numpy, counts taken over only the
active words against the dense plain version and the JAX reference, and
the decode kernel's split plan.  The CUDA launches themselves are held
against these plain versions in ``test_torch_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.inverted_index import from_uint32  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_decode import TILE, split_plan  # noqa: E402
from repro_torch.kernels.postings import ROWS  # noqa: E402
from torch_operands import query_masks  # noqa: E402


def _np_active(masks, rows):
    """Each tile's active words, by a loop over numpy rows."""
    b, w = masks.shape
    out = []
    for t0 in range(0, b, rows):
        tile = masks[t0:t0 + rows]
        out.append([j for j in range(w) if tile[:, j].any()])
    return out


def _cases(rng):
    zeros = np.zeros((40, 37), np.uint32)                 # all-zero tiles
    edge = np.zeros((33, 70), np.uint32)                  # one word at W - 1
    edge[32, 69] = 0x80000000
    ragged = rng.integers(0, 1 << 32, (45, 50), dtype=np.uint32)
    ragged[rng.random(ragged.shape) < 0.9] = 0            # B not a tile multiple
    dense = rng.integers(1, 1 << 32, (64, 20), dtype=np.uint32)
    single = np.full((1, 1), 5, np.uint32)                # B = W = 1
    last_row = np.zeros((6, 40), np.uint32)               # only row B - 1
    last_row[5, rng.choice(40, 3, replace=False)] = 1
    return {"zeros": zeros, "edge": edge, "ragged": ragged, "dense": dense,
            "single": single, "last_row": last_row,
            "query1": query_masks(rng, 3, 32, 500, 0.01),
            "query5": query_masks(rng, 3, 32, 500, 0.05)}


@pytest.mark.parametrize("case", ["zeros", "edge", "ragged", "dense",
                                  "single", "last_row", "query1", "query5"])
def test_active_words_match_numpy(case):
    rows = ROWS
    masks = _cases(np.random.default_rng(0))[case]
    words, n = ref.active_words_ref(from_uint32(masks, "cpu"), rows)
    want = _np_active(masks, rows)
    assert words.dtype == torch.int32 and n.dtype == torch.int32
    assert words.shape == (len(want), masks.shape[1])
    assert n.tolist() == [len(x) for x in want]
    for t, x in enumerate(want):
        assert words[t, :len(x)].tolist() == x
        assert (words[t, len(x):] == -1).all()
    if case == "zeros":
        assert n.sum() == 0
    if case == "dense":
        assert (n == masks.shape[1]).all()
    if case == "edge":
        assert words[-1, 0] == 69 and n[-1] == 1


@pytest.mark.parametrize("case", ["zeros", "edge", "ragged", "single",
                                  "last_row", "query1", "query5"])
def test_counts_over_active_words_are_exact(case):
    """Counts that walk each tile's active words only equal the dense plain
    version and the JAX reference's ``postings_counts``, exactly."""
    rows = ROWS
    rng = np.random.default_rng(1)
    masks = _cases(rng)[case]
    packed = rng.integers(0, 1 << 32, (masks.shape[1], 300), dtype=np.uint32)
    tm, tp = from_uint32(masks, "cpu"), from_uint32(packed, "cpu")
    words, n = ref.active_words_ref(tm, rows)
    sparse = torch.zeros((masks.shape[0], 300), dtype=torch.int32)
    for t in range(words.shape[0]):
        sel = words[t, :int(n[t])].long()
        r = slice(t * rows, (t + 1) * rows)
        sparse[r] = ref.postings_counts_ref(tm[r][:, sel], tp[sel])
    assert torch.equal(sparse, ref.postings_counts_ref(tm, tp))
    want = np.asarray(jops.postings_counts(jnp.asarray(masks),
                                           jnp.asarray(packed),
                                           backend="xla"))
    np.testing.assert_array_equal(sparse.numpy(), want)


@pytest.mark.parametrize("b,hkv,sms", [(128, 8, 132), (1, 8, 132),
                                       (1, 1, 132), (3, 4, 16),
                                       (64, 2, 114)])
def test_split_plan_gives_whole_tiles_covering_s(b, hkv, sms):
    ss = sorted({1, 2, 63, 64, 65, 127, 4100, 32_768, 524_287, 524_288}
                | set(np.random.default_rng(b).integers(1, 524_289, 200)
                      .tolist()))
    for s in ss:
        split_len, n_split = split_plan(b, hkv, s, sms)
        assert n_split >= 1 and split_len % TILE == 0 and split_len > 0
        assert split_len * n_split >= s            # covers S
        assert (n_split - 1) * split_len < s       # no empty split


def test_split_plan_at_the_decode_cells():
    """decode_32k: 128 x 8 x 5 = 5,120 CTAs, about 19 waves of 2 CTAs on
    each of 132 SMs; long_500k: 16 waves would leave each CTA 16 tiles, so
    it takes 64-tile splits, 8 x 128 = 1,024 CTAs."""
    assert TILE == 64
    assert split_plan(128, 8, 32_768, 132) == (103 * 64, 5)
    assert split_plan(1, 8, 524_288, 132) == (64 * 64, 128)
    assert split_plan(1, 8, 100, 132) == (128, 1)     # fewer tiles than 64
