"""The port's DeepFM, SASRec and BERT4Rec (and DLRM through the same
unified interface) against the JAX reference's, on the CPU.

Parameters come from the reference's ``init_params`` (as numpy) at its
``reduced_config`` (the published widths, 1,000 rows per field or items,
sequences of 16) and are carried across by ``params_from_reference``;
batches come from both packages' ``recsys_batch`` and a numpy seed.  fp32
tolerance: rtol = atol = 1e-5 where the arithmetic is the reference's
(sums taken in another order); DLRM's logits rtol 1e-4 as in
``test_torch_recsys.py`` (four MLP layers and the interaction).  Configs,
batches and the embedding substrate's integer paths are compared exactly.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.data.pipeline import recsys_batch as jax_batch  # noqa: E402
from repro.launch.train import reduced_config  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.configs import get_config, replace  # noqa: E402
from repro_torch.data import recsys_batch  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
RTOL = ATOL = 1e-5
ARCHS = ["deepfm", "sasrec", "bert4rec", "dlrm-rm2"]
SEQ = ("sasrec", "bert4rec")
N_CAND = 20


def _tol(arch):
    return dict(rtol=1e-4 if arch == "dlrm-rm2" else RTOL, atol=ATOL)


def _port_config(arch):
    jcfg = reduced_config(JC.get_config(arch))
    return jcfg, replace(get_config(arch), vocab_per_field=1000,
                         n_items=1000, seq_len=jcfg.seq_len)


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    arch = request.param
    jcfg, cfg = _port_config(arch)
    params = JR.init_params(jcfg, jax.random.PRNGKey(0))
    model = R.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return arch, jcfg, params, cfg, model


def _batches(cfg, n, step, seed=0):
    """A ``recsys_batch`` (with seeded candidates (n, N_CAND) for the
    sequential models) as numpy, JAX and CPU tensors."""
    b = recsys_batch(cfg, n, step, seed=seed)
    if "seq" in b:
        b["candidates"] = np.random.default_rng(step).integers(
            0, cfg.n_items, (n, N_CAND)).astype(np.int32)
    return b, {k: jnp.asarray(v) for k, v in b.items()}, R.as_batch(b, "cpu")


# ---------------------------------------------------------------------------
# configs and batches
# ---------------------------------------------------------------------------


def test_list_archs_is_the_references_in_order():
    assert TC.list_archs() == JC.list_archs()


@pytest.mark.parametrize("arch", JC.list_archs())
def test_get_config_equals_the_references_field_for_field(arch):
    got, want = TC.get_config(arch), JC.get_config(arch)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [(s.name, s.kind, s.dims) for s in got.shapes] == [
        (s.name, s.kind, s.dims) for s in want.shapes]


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch 'no-such-arch'"):
        TC.get_config("no-such-arch")


@pytest.mark.parametrize("arch", SEQ)
@pytest.mark.parametrize("step", [0, 5])
def test_sequential_recsys_batch_is_the_references_bit_for_bit(arch, step):
    jcfg, cfg = _port_config(arch)
    got, want = recsys_batch(cfg, 16, step, seed=2), jax_batch(jcfg, 16, step,
                                                               seed=2)
    assert sorted(got) == sorted(want) == ["mask", "neg", "pos", "seq"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _port_name(arch, name):
    """A reference leaf's path as the port's parameter name."""
    parts = name.split(".")
    if parts[0] in ("mlp", "bot", "top"):         # mlp.<i>.w -> mlp.w.<i>
        return f"{parts[0]}.{parts[2]}.{parts[1]}"
    return name


def test_params_from_reference_carry_every_weight(reference):
    arch, _, params, _, model = reference
    state = dict(model.named_parameters())
    leaves = dict(_leaves(params))
    assert {_port_name(arch, n) for n in leaves} == set(state)
    for name, want in leaves.items():
        got = state[_port_name(arch, name)]
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_array_equal(got.detach().numpy(), want, err_msg=name)


def test_seqrec_item_table_has_the_pad_and_mask_rows():
    _, cfg = _port_config("bert4rec")
    model = R.init_seqrec(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert model.item_emb.shape == (1000 + 2, 64)
    assert model.pos_emb.shape == (16, 64)
    assert len(model.blocks) == 2
    assert model.blocks[0].w1.shape == (64, 256)


def _std(t):
    return float(t.double().std())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_distributions_are_the_references(arch):
    """The same generator seed gives the same weights, another seed other
    ones; tables N(0, 1) x 0.01 (0.02 for the sequential embeddings),
    dense layers N(0, 1) / sqrt(in), norms 1, biases 0; the reference's
    weights have the same spreads."""
    jcfg, cfg = _port_config(arch)
    a = R.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = R.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    c = R.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    for (name, x), y, z in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(x, y), name
        if x.numel() > 1 and bool((x != x.flatten()[0]).any()):
            assert not torch.equal(x, z), name
    ref = dict(_leaves(JR.init_params(jcfg, jax.random.PRNGKey(0))))
    for name, x in a.named_parameters():
        want = ref[name] if name in ref else None
        if name.endswith(("b1", "b2", "fm_b")) or ".b." in name:
            assert bool((x == 0).all()), name
        elif name.endswith(("ln1", "ln2", "final_ln")):
            assert bool((x == 1).all()), name
        elif name in ("table", "fm_w"):
            assert abs(_std(x) - 0.01) < 1e-3, name
        elif name in ("item_emb", "pos_emb"):
            assert abs(_std(x) - 0.02) < 2e-3, name
        else:                                         # a dense layer
            fan_in = x.shape[0]
            assert abs(_std(x) * np.sqrt(fan_in) - 1.0) < 0.1, name
        if want is not None and x.numel() > 100:
            assert abs(_std(x) - float(want.std())) < 0.1 * float(
                want.std()) + 1e-12, name


# ---------------------------------------------------------------------------
# outputs
# ---------------------------------------------------------------------------


def test_deepfm_logits_match_reference():
    jcfg, cfg = _port_config("deepfm")
    params = JR.init_deepfm(jcfg, jax.random.PRNGKey(3))
    model = R.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    assert isinstance(model, R.DeepFM)
    _, jb, tb = _batches(cfg, 128, 2)
    want = np.asarray(JR.deepfm_logits(jcfg, params, jb))
    got = R.deepfm_logits(cfg, model, tb)
    assert got.dtype == torch.float32 and got.shape == (128,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)


def test_serve_fn_matches_reference(reference):
    arch, jcfg, params, cfg, model = reference
    _, jb, tb = _batches(cfg, 48, 1)
    want = np.asarray(JR.serve_fn(jcfg, params, jb))
    got = R.serve_fn(cfg, model, tb)
    assert got.dtype == torch.float32
    assert got.shape == ((48, N_CAND) if arch in SEQ else (48,))
    np.testing.assert_allclose(got.detach().numpy(), want, **_tol(arch))


def test_retrieval_fn_matches_reference(reference):
    """DeepFM / DLRM: 300 candidate rows, candidate-major; SASRec /
    BERT4Rec: one sequence (1, S) against 500 candidates (C,)."""
    arch, jcfg, params, cfg, model = reference
    if arch in SEQ:
        rng = np.random.default_rng(4)
        b = {"seq": rng.integers(0, cfg.n_items, (1, cfg.seq_len)).astype(
                 np.int32),
             "candidates": rng.integers(0, cfg.n_items + 2, (500,)).astype(
                 np.int32)}
        shape = (1, 500)
    else:
        b = recsys_batch(cfg, 300, 2, seed=1)
        shape = (300,)
    want = np.asarray(JR.retrieval_fn(jcfg, params,
                                      {k: jnp.asarray(v) for k, v in
                                       b.items()}))
    got = R.retrieval_fn(cfg, model, R.as_batch(b, "cpu"))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, **_tol(arch))


def test_loss_fn_matches_reference(reference):
    """``loss_fn``: ``pointwise_loss`` for DeepFM / DLRM, ``seqrec_loss``
    for SASRec / BERT4Rec (a mask with zeros), values only."""
    arch, jcfg, params, cfg, model = reference
    b, _, _ = _batches(cfg, 32, 3)
    if arch in SEQ:
        b["mask"][:, ::3] = 0.0
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = R.as_batch(b, "cpu")
    want, wm = JR.loss_fn(jcfg, params, jb)
    got, gm = R.loss_fn(cfg, model, tb)
    assert got.shape == () and sorted(gm) == sorted(wm) == ["loss"]
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)
    direct = (R.seqrec_loss if arch in SEQ else R.pointwise_loss)
    np.testing.assert_allclose(float(direct(cfg, model, tb)[0]), float(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", SEQ)
def test_seqrec_loss_of_an_all_masked_batch_is_zero(arch):
    jcfg, cfg = _port_config(arch)
    params = JR.init_params(jcfg, jax.random.PRNGKey(1))
    model = R.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    b, _, _ = _batches(cfg, 4, 0)
    b["mask"][:] = 0.0
    want = JR.seqrec_loss(jcfg, params, {k: jnp.asarray(v)
                                         for k, v in b.items()})[0]
    got = R.seqrec_loss(cfg, model, R.as_batch(b, "cpu"))[0]
    assert float(got) == float(want) == 0.0


@pytest.mark.parametrize("arch", SEQ)
def test_seqrec_scores_and_encoder_match_reference(arch):
    """The encoder's hidden states (causal for SASRec, bidirectional for
    BERT4Rec) and ``seqrec_scores`` over (B, S) hidden rows."""
    jcfg, cfg = _port_config(arch)
    params = JR.init_params(jcfg, jax.random.PRNGKey(2))
    model = R.params_from_reference(cfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    b, jb, tb = _batches(cfg, 8, 4)
    causal = arch == "sasrec"
    want_h = JR._seq_encode(jcfg, params, jb["seq"], causal=causal)
    got_h = R._seq_encode(cfg, model, tb["seq"], causal=causal)
    np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(want_h), rtol=RTOL,
                               atol=ATOL)
    ids = np.random.default_rng(5).integers(0, cfg.n_items + 2,
                                            (8, cfg.seq_len, 7))
    want = JR.seqrec_scores(jcfg, params, want_h, jnp.asarray(ids))
    got = R.seqrec_scores(cfg, model, got_h, torch.from_numpy(ids))
    assert got.shape == (8, cfg.seq_len, 7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # causal: the first position sees only itself, so a later item moves
    # nothing before it; bidirectional: every position sees it
    seq2 = tb["seq"].clone()
    seq2[:, -1] = (seq2[:, -1] + 1) % cfg.n_items
    moved = (R._seq_encode(cfg, model, seq2, causal=causal)
             - got_h).abs().amax(dim=(0, 2))
    assert bool((moved[:-1] == 0).all()) == causal


# ---------------------------------------------------------------------------
# the embedding substrate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def table():
    return np.random.default_rng(7).standard_normal((50, 6)).astype(
        np.float32)


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_reference(table, combiner, weighted):
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 50, (4, 3, 5)).astype(np.int32)
    w = rng.random((4, 3, 5)).astype(np.float32) if weighted else None
    want = JR.embedding_bag(jnp.asarray(table), jnp.asarray(ids), combiner,
                            None if w is None else jnp.asarray(w))
    got = R.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                          combiner=combiner,
                          weights=None if w is None else torch.from_numpy(w))
    assert got.shape == (4, 3, 6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_embedding_bag_mean_of_an_empty_bag_is_nan(table):
    ids = np.zeros((2, 0), np.int32)
    want = np.asarray(JR.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                       "mean"))
    got = R.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                          combiner="mean").numpy()
    assert np.isnan(want).all() and np.isnan(got).all()
    with pytest.raises(ValueError):
        R.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                        combiner="min")


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_embedding_bag_ragged_matches_reference_with_an_empty_bag(
        table, combiner):
    """Bag 2 of 5 is empty and bag 4 has one id: sum and mean give 0 for
    the empty bag, max gives -inf, as the reference's segment ops."""
    flat = np.asarray([0, 1, 7, 7, 3, 9, 12, 41, 2], np.int32)
    seg = np.asarray([0, 0, 1, 1, 1, 3, 3, 3, 4], np.int32)
    want = np.asarray(JR.embedding_bag_ragged(
        jnp.asarray(table), jnp.asarray(flat), jnp.asarray(seg), 5, combiner))
    got = R.embedding_bag_ragged(torch.from_numpy(table),
                                 torch.from_numpy(flat), torch.from_numpy(seg),
                                 5, combiner=combiner).numpy()
    assert got.shape == (5, 6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[2] == (-np.inf if combiner == "max" else 0.0)).all()


def test_embedding_bag_ragged_refuses_an_unknown_combiner(table):
    with pytest.raises(ValueError):
        R.embedding_bag_ragged(torch.from_numpy(table), torch.zeros(1, dtype=torch.int64),
                               torch.zeros(1, dtype=torch.int64), 1, "min")


# ---------------------------------------------------------------------------
# device, interaction and imports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepfm", "sasrec", "bert4rec"])
def test_side_recommenders_refuse_the_cpu_by_default(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _port_config(arch)
    init = R.init_deepfm if arch == "deepfm" else R.init_seqrec
    for fn in (init, R.init_params):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(cfg, torch.Generator())


def test_a_model_refuses_another_interaction():
    _, fm = _port_config("deepfm")
    _, seq = _port_config("sasrec")
    with pytest.raises(ValueError, match="DeepFM"):
        R.DeepFM(seq, device="cpu")
    with pytest.raises(ValueError, match="SeqRec"):
        R.SeqRec(fm, device="cpu")
    with pytest.raises(ValueError, match="DLRM"):
        R.DLRM(fm, device="cpu")


_BLOCKED = """
import sys
sys.modules["jax"] = None          # any import of jax or repro now raises
sys.modules["repro"] = None
import repro_torch.models.recsys, repro_torch.models.gnn
import repro_torch.data.sampler, repro_torch.data.pipeline
import repro_torch.configs
for arch in repro_torch.configs.list_archs():
    repro_torch.configs.get_config(arch)
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m == "repro" or m.startswith(("repro.", "jax"))))
print(leaked)
"""


def test_side_model_modules_import_with_jax_and_repro_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
