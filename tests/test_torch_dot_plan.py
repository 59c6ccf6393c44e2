"""The launch plan of the dot-interaction kernel (kernel 4), on the CPU.

The plan is computed in Python (``kernels/dot_interaction.py``) and passed
to the CUDA entry point, so what the kernel walks can be checked here:
every sample covered once, the grid over every SM at small B, shared
memory within a CTA's budget, and the plain load path exactly where the
bulk copies cannot fetch x.  The kernel itself runs only on the card
(``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dot_interaction as D  # noqa: E402

SMS = 132                                  # an H100 SXM


def _bounds(b, groups, g):
    """First and end sample of groups ``g``, as the kernel's group_start
    cuts B: B // groups samples each, one more in the first B % groups."""
    q, r = divmod(b, groups)
    start = g * q + np.minimum(g, r)
    return start, start + q + (g < r)


def _covered(b, plan, lay):
    """How often the kernel's walk reaches each sample: CTA c takes groups
    c, c + grid, ...; group g is samples [start, end) of _bounds;
    warp w takes the group's slots [w per_warp, (w + 1) per_warp)."""
    hits = np.zeros(b + 1, np.int64)
    for cta in range(plan.grid):
        g = np.arange(cta, plan.groups, plan.grid)
        start, end = _bounds(b, plan.groups, g)
        assert (end - start <= plan.samples).all()
        for w in range(plan.warps):
            lo = np.minimum(start + w * lay.per_warp, end)
            hi = np.minimum(lo + lay.per_warp, end)
            np.add.at(hits, lo, 1)
            np.add.at(hits, hi, -1)
    return np.cumsum(hits)[:b]


@pytest.mark.parametrize("b", [1, 7, 8, 9, 131, 512, 1001, 262_144,
                               1_000_000])
@pytest.mark.parametrize("f,e,itemsize", [(27, 64, 4), (27, 64, 2),
                                          (8, 16, 4), (2, 1, 4),
                                          (64, 256, 4)])
def test_every_sample_is_covered_once(b, f, e, itemsize):
    lay = D.layout(f, e, itemsize)
    for bulk in (True, False):
        plan = D.launch_plan(b, f, e, itemsize, bulk, SMS)
        assert plan.samples == plan.warps * lay.per_warp
        assert plan.grid <= plan.groups <= b
        np.testing.assert_array_equal(_covered(b, plan, lay), 1)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_small_batch_grid_covers_every_sm(itemsize):
    """B 512 (serve_p99): one wave over all 132 SMs, a CTA a SM, groups of 3
    and 4 samples, at most one sample a warp scheduler."""
    plan = D.launch_plan(512, 27, 64, itemsize, True, SMS)
    assert plan.grid == plan.groups == SMS
    assert plan.warps == plan.samples == 4
    assert plan.stages == 1                         # nothing to prefetch
    start, end = _bounds(512, SMS, np.arange(SMS))
    assert (start[1:] == end[:-1]).all() and (start[0], end[-1]) == (0, 512)
    assert set(end - start) == {3, 4}


def test_plan_switches_to_a_persistent_ring():
    """At F = 27 one sample a warp.  Up to MAX_WARPS * SMs samples, one wave
    of one CTA a SM with as many warps as the largest group; then groups of
    MAX_WARPS, a CTA each while they fit on the card at once; one group
    more and a grid of that many CTAs walks them through a ring of STAGES."""
    wave = D.MAX_WARPS * SMS
    for b, warps in ((SMS, 1), (SMS + 1, 2), (wave, D.MAX_WARPS)):
        plan = D.launch_plan(b, 27, 64, 4, True, SMS)
        assert (plan.groups, plan.grid, plan.warps) == (SMS, SMS, warps)
    past = D.launch_plan(wave + 1, 27, 64, 4, True, SMS)
    assert past.grid == past.groups == SMS + 1 and past.stages == 1
    bulk = D.launch_plan(262_144, 27, 64, 4, True, SMS)
    assert (bulk.warps, bulk.stages) == (D.MAX_WARPS, D.STAGES)
    assert bulk.threads == 32 * (D.MAX_WARPS + 1)      # and a producer warp
    per_sm = D.SMEM_PER_SM // (bulk.smem + 1024)
    assert per_sm >= 2 and bulk.grid == per_sm * SMS
    ring = bulk.grid * bulk.samples
    last, first = (D.launch_plan(b, 27, 64, 4, True, SMS)
                   for b in (ring, ring + 1))
    assert last.grid == last.groups and last.stages == 1
    assert first.grid == bulk.grid < first.groups
    assert first.stages == D.STAGES


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("b", [1, 512, 262_144, 1_000_000])
def test_shared_memory_within_a_ctas_budget(b, itemsize):
    """At the kernel's widest shape (F 64, E 256) and at dlrm-rm2's, on
    both paths, a CTA's ring, triangles and barriers fit in 227 KB."""
    for f, e in ((64, 256), (27, 64)):
        lay = D.layout(f, e, itemsize)
        for bulk in (True, False):
            plan = D.launch_plan(b, f, e, itemsize, bulk, SMS)
            assert plan.smem <= D.SMEM_MAX
            ring = plan.stages * plan.samples * lay.sample_bytes
            assert ring + plan.samples * lay.pairs * 4 < plan.smem
            assert plan.smem == D.smem_bytes(lay, plan.samples, plan.stages)


def test_layout_skews_blocks_and_keeps_an_odd_sample_pitch():
    lay = D.layout(27, 64, 4)
    assert (lay.pairs, lay.tiles, lay.lanes) == (351, 28, 32)
    assert lay.row_bytes == 256
    assert lay.sample_bytes == 7 * (4 * 256 + 16) == 7280   # 455 words
    wide = D.layout(64, 256, 4)                  # 16 blocks of 4,112 bytes
    assert wide.sample_bytes == 16 * 4112 + 16 and wide.lanes == 32
    assert D.layout(63, 63, 2).row_bytes == 128  # 126 bytes, whole words
    for f, e, s in ((27, 64, 4), (27, 64, 2), (64, 256, 4), (8, 16, 4),
                    (2, 1, 2), (40, 10, 4)):
        assert (D.layout(f, e, s).sample_bytes // 16) % 2 == 1
    assert D.layout(8, 16, 4).per_warp == 8      # 3 tiles: 4 lanes a sample
    assert D.layout(2, 1, 4).per_warp == 32


@pytest.mark.parametrize("itemsize", [4, 2])
def test_plain_path_exactly_where_bulk_copies_cannot_fetch(itemsize):
    """Bulk copies need a 16-byte aligned x and rows of whole 16-byte
    words; everything else takes the plain path, which has no ring."""
    for e in range(1, 257):
        for ptr in (0, 2, 4, 8, 12, 16, 1024, 1030):
            want = ptr % 16 == 0 and (e * itemsize) % 16 == 0
            assert D.bulk_ok(ptr, e, itemsize) is want, (ptr, e)
    for b in (1, 512, 262_144):
        plan = D.launch_plan(b, 27, 63, itemsize, False, SMS)
        assert not plan.bulk and plan.stages == 1
        assert plan.threads == 32 * plan.warps          # no producer warp
    assert D.launch_plan(262_144, 27, 64, itemsize, True,
                         SMS).threads == 32 * (D.MAX_WARPS + 1)


def test_plan_invariants_over_random_shapes():
    rng = np.random.default_rng(0)
    for _ in range(400):
        b = int(rng.integers(1, 3_000_000))
        f, e = int(rng.integers(2, 65)), int(rng.integers(1, 257))
        itemsize, bulk = int(rng.choice([2, 4])), bool(rng.integers(0, 2))
        sms = int(rng.choice([1, 66, 132, 144]))
        plan = D.launch_plan(b, f, e, itemsize, bulk, sms)
        lay = D.layout(f, e, itemsize)
        assert 1 <= plan.warps <= D.MAX_WARPS
        assert 1 <= plan.stages <= (D.STAGES if bulk else 1)
        assert plan.stages <= -(-plan.groups // plan.grid)
        assert 1 <= plan.grid <= plan.groups <= b and plan.grid <= sms * 16
        assert -(-b // plan.groups) <= plan.samples
        assert plan.samples == plan.warps * lay.per_warp
        assert plan.smem <= D.SMEM_MAX and plan.threads <= 288
