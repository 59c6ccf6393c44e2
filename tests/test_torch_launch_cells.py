"""The port's dry-run cells, counter and roofline (``repro_torch.launch``)
against the reference's (``repro.launch``), exact unless a tolerance is
stated.

For all 44 cells, ``plan_cell`` on a one-device mesh (the port's on
``meta``, the reference's on the CPU device) gives the reference's kind,
donations, note, model FLOPs and bytes (rtol 1e-12), every argument's
shape and dtype (the reference's uint32 bitmaps are the port's int32 bit
patterns) and every input sharding's spec.  Then the counter's
arithmetic, the HLO collective parser on the reference's strings and the
roofline terms on the H100 constants.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.cells as RC  # noqa: E402
import repro.launch.roofline as RRL  # noqa: E402
import repro.launch.sharding as RS  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import cells as C  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402

CELLS = list(RC.all_cells())
# the reference's PackedIndex fields, flattened as jax flattens a NamedTuple
_FIELDS = {".packed": "[0]", ".doc_freq": "[1]", ".n_docs": "[2]"}


@pytest.fixture(autouse=True)
def _default_knobs(monkeypatch):
    for k in ("REPRO_COOC_METHOD", "REPRO_BUILD_DTYPE", "REPRO_CACHE_DTYPE",
              "REPRO_DECODE_FSDP", "REPRO_UNROLL_SCANS"):
        monkeypatch.delenv(k, raising=False)


def _ref_args(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = []
    for p, x in flat:
        key = jax.tree_util.keystr(p)
        for attr, idx in _FIELDS.items():
            key = key.replace(attr, idx)
        dt = jnp.dtype(x.dtype).name
        out.append((key, tuple(x.shape), "int32" if dt == "uint32" else dt))
    return out


def _port_args(args):
    return [(pytree.keystr(p), tuple(x.shape),
             str(x.dtype).replace("torch.", ""))
            for p, x in pytree.flatten_with_path(C.arg_tree(list(args)))]


def _ref_specs(tree):
    leaves = jax.tree_util.tree_leaves(
        tree, is_leaf=lambda v: isinstance(v, jax.sharding.NamedSharding))
    return [tuple(s.spec) for s in leaves]


def _port_specs(tree):
    if isinstance(tree, S.NamedSharding):
        return [tuple(tree.spec)]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _port_specs(tree[k])]
    return [s for v in tree for s in _port_specs(v)]


def test_all_cells_are_the_reference_cells():
    assert list(C.all_cells()) == CELLS and len(CELLS) == 44
    assert list(C.all_cells(include_cooc=False)) == list(
        RC.all_cells(include_cooc=False))
    assert len(list(C.all_cells(include_cooc=False))) == 40


@pytest.fixture(scope="module")
def ref_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_plan_cell_equals_the_reference(arch, shape, ref_mesh):
    with RS.axis_rules(ref_mesh):
        want = RC.plan_cell(arch, shape)
    with S.axis_rules(M.make_host_mesh("meta")):
        got = C.plan_cell(arch, shape)
    assert (got.arch, got.shape, got.kind) == (want.arch, want.shape,
                                               want.kind)
    assert tuple(got.donate_argnums) == tuple(want.donate_argnums)
    assert got.note == want.note
    np.testing.assert_allclose(got.model_flops, want.model_flops,
                               rtol=1e-12)
    np.testing.assert_allclose(got.model_bytes, want.model_bytes,
                               rtol=1e-12)
    assert _port_args(got.args) == _ref_args(want.args)
    assert {x.device.type for _, x in pytree.flatten_with_path(
        C.arg_tree(list(got.args)))} == {"meta"}
    assert _port_specs(got.in_shardings) == _ref_specs(want.in_shardings)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------


def test_counter_arithmetic_on_meta():
    a = torch.empty(64, 128, device="meta")
    b = torch.empty(128, 32, device="meta")
    with RL.Counter() as c:
        a @ b
    assert c.flops == 2 * 64 * 128 * 32
    assert c.bytes == (64 * 128 + 128 * 32 + 64 * 32) * 4
    x = torch.empty(1000, device="meta", dtype=torch.bfloat16)
    with RL.Counter() as c:
        y = x + x                        # operands and result
        x.view(10, 100).t()              # views move nothing
        y.copy_(x)                       # a copy: its source and target
        torch.empty_like(x)              # allocation without a write
        z = x.to(torch.float32)
    assert c.flops == 0
    assert c.bytes == 3 * 2000 + 2 * 2000 + 2000 + 4000
    assert c.peak_bytes == 2000 + 2000 + 4000 and z.shape == x.shape
    i8 = torch.empty(32, 64, device="meta", dtype=torch.int8)
    with RL.Counter() as c:
        torch._int_mm(i8, i8.t())
    assert c.flops == 2 * 32 * 64 * 32


@pytest.mark.parametrize("name", ["postings_counts", "level_step",
                                  "cooccur_counts", "dot_interaction",
                                  "flash_decode"])
def test_a_kernel_wrapper_on_meta_adds_exactly_its_counts(name):
    meta = dict(device="meta")
    i32 = dict(meta, dtype=torch.int32)
    if name == "postings_counts":
        args = (torch.empty(8, 12, **i32), torch.empty(12, 100, **i32))
        call, kw = ops.postings_counts, {}
        shape = (8, 100)
    elif name == "level_step":
        args = (torch.empty(8, 12, **i32), torch.empty(12, 104, **i32),
                torch.empty(8, **i32), torch.empty(8, device="meta",
                                                   dtype=torch.bool),
                torch.empty(2, 100, device="meta", dtype=torch.bool))
        call, kw = ops.level_step, dict(v=100, k=16)
        shape = (8, 16)
    elif name == "cooccur_counts":
        x = torch.empty(40, 64, device="meta", dtype=torch.int8).t()
        args, call, kw, shape = (x, x), ops.cooccur_counts, {}, (40, 40)
    elif name == "dot_interaction":
        args = (torch.empty(16, 27, 64, **meta),)
        call, kw, shape = ops.dot_interaction, {}, (16, 351)
    else:
        args = (torch.empty(2, 8, 64, **meta),
                torch.empty(2, 100, 2, 64, **meta),
                torch.empty(2, 100, 2, 64, **meta))
        call, kw, shape = ops.flash_decode, {}, (2, 8, 64)
    if name == "flash_decode":
        kw = dict(length=torch.full((2,), 50))
    before = dict(ops.LAUNCHES)
    with RL.Counter() as c:
        out = call(*args, **kw)
    out = out[0] if name == "level_step" else out
    assert tuple(out.shape) == shape and out.device.type == "meta"
    want = ops.kernel_cost(name, *args, **{k: v for k, v in kw.items()
                                           if k != "length"})
    assert c.kernels == {name: {"launches": 1, "ops": want[0],
                                "bytes": want[1]}}
    # the kernel's operations stand apart from the FLOPs, on its own unit
    assert c.flops == 0 and c.kernel_ops == want[0] and c.bytes == want[1]
    assert c.kernel_seconds == want[0] / RL.KERNEL_RATES[name]
    assert ops.LAUNCHES == before            # a stand-in, not a launch


def test_kernel_costs_are_the_kernel_tables():
    """kernel_cost's counts are those the kernel table's bounds use:
    kernel 4 (fp32) 2·B·P·E operations and (B·F·E + B·P)·4 bytes, kernel 5
    4·B·Hq·S·d and twice the cache and query, kernel 3 2·D·Vl·Vr."""
    b, f, e, p = 16, 27, 64, 27 * 26 // 2
    x = torch.empty(b, f, e, device="meta")
    assert ops.kernel_cost("dot_interaction", x) == (
        2 * b * p * e, b * f * e * 4 + b * p * 4)
    q = torch.empty(2, 8, 64, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 100, 2, 64, device="meta", dtype=torch.bfloat16)
    assert ops.kernel_cost("flash_decode", q, k, k) == (
        4 * 2 * 8 * 100 * 64, 2 * k.numel() * 2 + 2 * q.numel() * 2 + 2 * 4)
    xl = torch.empty(40, 64, device="meta", dtype=torch.int8)
    xr = torch.empty(40, 32, device="meta", dtype=torch.int8)
    assert ops.kernel_cost("cooccur_counts", xl, xr) == (
        2 * 40 * 64 * 32, 40 * 64 + 40 * 32 + 64 * 32 * 4)


def test_from_counts_divides_by_the_chips():
    a = torch.empty(64, 128, device="meta")
    with RL.Counter() as c:
        a @ a.t()
    one = RL.from_counts(c, 1, 1e6, 1e3)
    many = RL.from_counts(c, 256, 1e6, 1e3)
    assert one.coll_bytes_per_dev == 0.0 and one.t_collective == 0.0
    assert many.coll_bytes_per_dev is None and many.t_collective is None
    assert many.flops_per_dev * 256 == one.flops_per_dev == c.flops
    assert many.to_dict()["collective_note"] == "no partitioner"
    assert many.bottleneck in ("compute", "memory")


# ---------------------------------------------------------------------------
# the parser and the roofline terms
# ---------------------------------------------------------------------------

HLO = """
  %ag = f32[8,128]{1,0} all-gather(f32[1,128]{1,0} %x), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %ar = f32[64]{0} all-reduce(f32[64]{0} %y), replica_groups=[4,2]<=[8], to_apply=%add
  %cp = f32[32]{0} collective-permute(f32[32]{0} %z), source_target_pairs={{0,1}}
  %rs = bf16[16,4]{1,0} reduce-scatter(bf16[64,4]{1,0} %w), replica_groups=[2,4]<=[8], dimensions={0}
  %t = (f32[4]{0}, s32[2,2]{1,0}) all-to-all(f32[4]{0} %a, s32[2,2]{1,0} %b), replica_groups={{0,1}}
  %ars = f32[10]{0} all-reduce-start(f32[10]{0} %c), replica_groups={{0}}
  %n = f32[10]{0} add(f32[10]{0} %c, f32[10]{0} %c)
"""


def test_parse_collectives_equals_the_reference():
    got, want = RL.parse_collectives(HLO), RRL.parse_collectives(HLO)
    assert got.counts == want.counts == {
        "all-gather": 1, "all-reduce": 1, "collective-permute": 1,
        "reduce-scatter": 1, "all-to-all": 1}
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.total_bytes == want.total_bytes
    assert got.summary() == want.summary()
    assert got.bytes_by_kind["reduce-scatter"] == 16 * 4 * 2 * 3
    for line in HLO.strip().splitlines():
        if "=" in line:
            assert RL._result_bytes(line) == RRL._result_bytes(line)
            assert RL._group_size(line) == RRL._group_size(line)


def test_roofline_terms_are_the_h100s():
    r = RL.Roofline(flops_per_dev=1e12, hbm_bytes_per_dev=1e9,
                    coll_bytes_per_dev=1e8, n_chips=256, model_flops=2e14,
                    model_bytes=1e11)
    assert r.t_compute == pytest.approx(1e12 / 989e12)
    assert r.t_memory == pytest.approx(1e9 / 3.35e12)
    assert r.t_collective == pytest.approx(1e8 / 450e9)
    assert r.bottleneck == "compute"
    assert r.useful_ratio == pytest.approx(2e14 / (1e12 * 256))
    assert r.t_model == pytest.approx(max(2e14 / (256 * 989e12),
                                          1e11 / (256 * 3.35e12)))
    assert r.roofline_fraction == pytest.approx(r.t_model / r.t_compute)
    d = r.to_dict()
    assert set(RRL.Roofline(1e12, 1e9, 1e8, 256, 2e14).to_dict()) <= set(d)


def test_kernel_operations_are_held_to_their_units_rates():
    """Kernels 1 and 2's AND+popcount words go at the popcount rate
    (132 SMs x 16 a clock x 1.98 GHz), not the bf16 tensor cores'."""
    assert M.PEAK_POPC == pytest.approx(4.18176e12)
    masks = torch.empty(256, 12382, device="meta", dtype=torch.int32)
    packed = torch.empty(12382, 65536, device="meta", dtype=torch.int32)
    with RL.Counter() as c:
        ops.postings_counts(masks, packed)
    r = RL.from_counts(c, 1, 1e9)
    n = 256 * 12382 * 65536
    assert r.flops_per_dev == 0 and r.kernel_ops_per_dev == n
    assert r.t_compute == pytest.approx(n / M.PEAK_POPC)
    assert r.t_compute > 200 * n / M.PEAK_FLOPS_BF16
    assert r.bottleneck == "compute"
    assert r.useful_ratio == pytest.approx(1e9 / n)
    assert r.to_dict()["t_kernel_ops_s"] == r.t_compute
    both = RL.Roofline(1e12, 0.0, 0.0, 1, 0.0, kernel_ops_per_dev=5.0,
                       kernel_s_per_dev=2.0)
    assert both.t_compute == pytest.approx(1e12 / 989e12 + 2.0)


# ---------------------------------------------------------------------------
# the co-occurrence cells' data: the CSL corpus model
# ---------------------------------------------------------------------------


def test_cooc_cell_documents_follow_the_corpus_model():
    """The documents a CSL cell draws on a device have the statistics of
    the reference's ``synthetic_csl`` (Poisson(12) lengths, Zipf(1.15)
    ids): mean length, the head term's share of the tokens, distinct
    terms a document and the postings' density, at 20,000 documents over
    the full 65,536 terms."""
    from repro.data import synthetic_csl as ref_csl
    n, v = 20_000, 65_536
    docs = C.csl_docs(n, v, C._Inputs("cpu", 3)).numpy()
    valid = docs >= 0
    assert valid[:, 0].all() and docs.max() < v
    lens = valid.sum(1)
    want = ref_csl(n, v, seed=3)
    want_lens = np.array([len(d) for d in want])
    assert lens.mean() == pytest.approx(want_lens.mean(), rel=0.02)
    flat = np.concatenate(want)
    assert (docs[valid] == 0).mean() == pytest.approx((flat == 0).mean(),
                                                      rel=0.05)
    distinct = sum(len(np.unique(r[r >= 0])) for r in docs)
    want_distinct = sum(len(set(d)) for d in want)
    assert distinct == pytest.approx(want_distinct, rel=0.02)
    # the density the model gives: mean over terms of 1 - exp(-12 p_t)
    r = np.arange(1, v + 1, dtype=np.float64)
    p = (r + 2.7) ** -1.15
    p /= p.sum()
    assert distinct / (n * v) == pytest.approx(
        (1 - np.exp(-12 * p)).mean(), rel=0.03)


def test_cooc_cell_index_is_built_from_the_corpus_model(monkeypatch):
    """On a device the CSL index holds the corpus model's documents in its
    first slots, its ``doc_freq`` their column popcounts; the ingest cell
    leaves its block's slots free, and its block and seeds are in range."""
    import repro_torch.configs.cooccur_csl as CC
    from repro_torch.configs import replace
    from repro_torch.kernels.ref import popcount32
    monkeypatch.setattr(CC, "CONFIG", replace(CC.CONFIG, vocab_size=256,
                                              n_docs=6000))
    mesh = M.make_host_mesh("cpu")
    with S.axis_rules(mesh):
        query = C.plan_cell("cooccur-csl", "query_bfs_d3", device="cpu")
        ing = C.plan_cell("cooccur-csl", "stream_ingest", device="cpu")
    idx = query.args[0]
    assert int(idx.n_docs) == 6000
    assert torch.equal(idx.doc_freq,
                       popcount32(idx.packed).sum(0, dtype=torch.int32))
    assert int(popcount32(idx.packed[:6000 // 32]).sum()) > 0
    index, terms, valid, seeds = ing.args
    live = 6000 - 4096
    assert int(index.n_docs) == live
    assert int(popcount32(index.packed[live // 32 + 1:]).sum()) == 0
    assert valid.all() and terms.shape == (4096, 64)
    assert int(terms.max()) < 256 and int(terms[:, 0].min()) >= 0
    assert seeds.dtype == torch.int32 and 0 <= int(seeds.min()) and \
        int(seeds.max()) < 256
    from repro_torch.core import ingest
    after = ingest(index, terms, valid)
    assert after.n_docs == 6000
    assert int(popcount32(after.packed[live // 32 + 1:]).sum()) > 0
    assert int(after.doc_freq.sum()) > int(index.doc_freq.sum())
