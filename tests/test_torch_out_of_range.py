"""Ids out of range, answered as the JAX reference answers them, on the CPU.

The reference gathers and scatters by a caller's ids under JAX's rules:
``x[ids]`` wraps an id in [-n, 0) and clamps any other; ``jnp.take``
(default mode) and ``take_along_axis`` wrap [-n, 0) and fill any other
with NaN; ``segment_sum`` / ``segment_max`` drop an id outside [0, n).
The port must give the same answers (its ops would raise, and on a card
stop with a device-side assert).  Each site of the port that takes an id
from a caller is held to the reference here on the same numpy-seeded
inputs, with ids at and past both ends:

1. the BFS seeds (``initial_state``): ``bfs_construct_batch``,
   ``CoocEngine`` and ``CoocServer`` under all four methods, unsharded
   and on a term and a doc mesh, and a random differential with seeds V
   and V + 3;
2. ``term_postings`` / ``and_term``;
3. LM tokens: ``prefill``, ``decode_step`` and ``DecodeServer`` streams
   (llama, and deepseek's MLA + MoE routing over a NaN token);
4. label gathers in the LM and GIN losses, and GIN's first argmax over
   NaN;
5. ``embedding_bag`` and ``embedding_bag_ragged`` (all three combiners);
6. DLRM and DeepFM ``serve_fn`` / ``retrieval_fn`` / ``loss_fn``;
7. SASRec and BERT4Rec, an id in the sequence and among the candidates;
8. GIN's edge sources, destinations and graph ids.

NaN positions must be equal and the finite values within the tolerances
of ``test_torch_side_recsys.py`` (rtol = atol = 1e-5; DLRM rtol 1e-4),
``test_torch_lm_serving.py`` (token streams equal) and
``test_torch_gnn.py`` (1e-5); counts, ids and weights exactly.  The
helpers of ``repro_torch.models.layers`` are held to ``jnp.take``,
``take_along_axis`` and ``segment_sum`` directly.
"""
import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.core as J  # noqa: E402
import repro.serve as JS  # noqa: E402
from repro.launch.train import reduced_config  # noqa: E402
from repro.models import gnn as JG  # noqa: E402
from repro.models import recsys as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.data import gnn_synthetic_graph, lm_batch, recsys_batch  # noqa: E402
from repro_torch.models import gnn as G  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import CoocEngine, CoocServer, DecodeServer  # noqa: E402
from repro_torch.serve import ServerConfig, TenantConfig  # noqa: E402

RTOL = ATOL = 1e-5
METHODS = ("gemm", "popcount", "pallas", "fused")
MESHES = (None, "terms", "docs")


def _same_nan(got, want, **tol):
    """NaN where the reference has NaN and nowhere else; the finite values
    within ``tol`` (exact without one)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if tol:
        np.testing.assert_allclose(got, want, **tol)
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the helpers against JAX's own ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_ids", [6, 40])          # fewer / more ids than rows
@pytest.mark.parametrize("shape", [(9, 3), (9,)])
def test_take_is_jnp_take(shape, n_ids):
    rng = np.random.default_rng(n_ids)
    table = rng.standard_normal(shape).astype(np.float32)
    ids = rng.integers(-12, 13, n_ids).astype(np.int32)
    ids[:4] = [-9, -10, 9, 8]                       # both ends
    want = jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0)
    got = L.take(torch.from_numpy(table), torch.from_numpy(ids))
    _same_nan(got, want)


def test_take_keeps_the_gradient_of_the_rows_it_reads():
    table = torch.arange(12.0).reshape(4, 3).requires_grad_()
    out = L.take(table, torch.tensor([1, 7, -1]))
    out[torch.isfinite(out)].sum().backward()
    want = np.zeros((4, 3), np.float32)
    want[1] = want[3] = 1.0
    np.testing.assert_array_equal(table.grad.numpy(), want)


@pytest.mark.parametrize("remat", [False, True])
def test_take_gradient_with_more_ids_than_rows_is_the_same_in_every_run(
        remat):
    """2,048 ids over 16 rows: the table's gradient through ``take`` is
    the same bit for bit in three runs, with and without recomputation
    (``torch.utils.checkpoint``, as ``cfg.remat`` runs it), and equal to
    the one that adds the ids' rows in order (``index_select``'s)."""
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 16, (64, 32)).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal((64, 32, 8)).astype(np.float32))

    def grad(gather, remat):
        t = table.clone().requires_grad_()

        def loss(t):
            return (gather(t) * w).sum()
        (torch.utils.checkpoint.checkpoint(loss, t, use_reentrant=False)
         if remat else loss(t)).backward()
        return t.grad.numpy()
    want = grad(lambda t: torch.index_select(t, 0, ids.reshape(-1))
                .reshape(64, 32, 8), False)
    for _ in range(3):
        np.testing.assert_array_equal(grad(lambda t: L.take(t, ids), remat),
                                      want)


def test_lm_embedding_gradient_with_more_tokens_than_rows(lms):
    """llama at ``reduced_config`` (vocab 512) trained on 4 x 160 tokens:
    the embedding's gradient is the same bit for bit in two runs, the
    same with remat on (within ``test_torch_grads.py``'s remat
    tolerance) and equal to the reference's ``jax.grad``."""
    lm = lms("llama3-8b")
    b = lm_batch(lm.cfg, 4, 160, step=2)
    assert b["tokens"].size > lm.cfg.padded_vocab
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    grads = []
    for remat in (False, False, True):
        c = TC.replace(lm.cfg, remat=remat)
        lm.model.zero_grad(set_to_none=True)
        TT.loss_fn(c, lm.model, tb)[0].backward()
        grads.append(lm.model.embed.grad.clone())
    lm.model.zero_grad(set_to_none=True)
    np.testing.assert_array_equal(grads[1].numpy(), grads[0].numpy())
    torch.testing.assert_close(grads[2], grads[0], rtol=1e-5, atol=1e-7)
    jg = jax.grad(lambda p: JT.loss_fn(lm.jcfg, p, {
        k: jnp.asarray(v) for k, v in b.items()})[0])(lm.params)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg["embed"]),
                               rtol=1e-4, atol=1e-5)


def test_take_along_last_is_take_along_axis():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 5, 6)).astype(np.float32)
    ids = np.asarray(rng.integers(-8, 9, (4, 5)), np.int32)
    ids[0, :4] = [-6, -7, 6, 5]
    want = jnp.take_along_axis(jnp.asarray(x), jnp.asarray(ids)[..., None],
                               axis=-1)[..., 0]
    _same_nan(L.take_along_last(torch.from_numpy(x), torch.from_numpy(ids)),
              want)


@pytest.mark.parametrize("op", ["sum", "max"])
def test_segment_ops_drop_what_jax_drops(op):
    rng = np.random.default_rng(2)
    data = rng.standard_normal((12, 3)).astype(np.float32)
    seg = np.asarray([0, 1, 5, -1, -4, 2, 3, 4, 4, 7, 0, -5], np.int32)
    if op == "sum":
        want = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(seg), 5)
        got = L.segment_sum(torch.from_numpy(data), torch.from_numpy(seg), 5)
        _same_nan(got, want, rtol=RTOL, atol=ATOL)
    else:
        want = jax.ops.segment_max(jnp.asarray(data), jnp.asarray(seg), 5)
        got = R.embedding_bag_ragged(
            torch.from_numpy(data), torch.arange(12), torch.from_numpy(seg),
            5, combiner="max")
        _same_nan(got, want)


# ---------------------------------------------------------------------------
# 1. BFS seeds
# ---------------------------------------------------------------------------

PROBE_DOCS = [[0, 1, 2], [1, 2, 3], [0, 3], [2, 4], [0, 1, 4]]
PROBE_V = 5
PROBE_PLAN = dict(depth=2, topk=2, beam=2)
# seed rows (beam 2, padded with -1): V and V + 3 alone, beside a good
# seed, and good ones; the engine and server take each row as a request
PROBE_SEEDS = np.asarray([[1, -1], [5, -1], [8, -1], [4, 5], [7, 2], [2, -1],
                          [3, 5], [0, 8]], np.int32)


def _slots(net):
    return np.stack([np.asarray(getattr(net, f)).astype(np.int64)
                     for f in ("src", "dst", "weight", "valid")])


def _per_query(net, q):
    """(Q, 4, slots) from a batch network's (4, Q * slots) layout."""
    s = _slots(net)
    return s.reshape(4, q, -1).transpose(1, 0, 2)


def _jit_bfs(method, plan):
    return jax.jit(lambda idx, seeds: J.bfs_construct_batch(
        idx, seeds, method=method, **plan))


@pytest.fixture(scope="module")
def probe_ref():
    """The reference's answers to PROBE_SEEDS, one batch per method."""
    idx = J.pack_docs(PROBE_DOCS, PROBE_V)
    return {m: _per_query(_jit_bfs(m, PROBE_PLAN)(idx,
                                                  jnp.asarray(PROBE_SEEDS)),
                          len(PROBE_SEEDS))
            for m in METHODS}


def _ctx(docs, v, mesh):
    kw = {} if mesh is None else dict(
        mesh=T.make_cooc_mesh(devices=["cpu"] * 3, shard=mesh))
    return T.QueryContext.from_docs(docs, v, device="cpu", **kw)


def _spec(row):
    return tuple(int(t) for t in row if t >= 0)


def test_the_probe_seed_is_served_over_the_last_column(probe_ref):
    """The recorded probe: seed 5 with V = 5, submitted beside seed 1, is
    served by the reference's engine over column 4, labelled 5; the
    port's engine answers both."""
    j = JS.CoocEngine(J.QueryContext.from_docs(PROBE_DOCS, PROBE_V),
                      method="gemm", **PROBE_PLAN)
    j_futs = [j.submit((1,)), j.submit((5,))]
    want = [_slots(f.result().network) for f in j_futs]
    np.testing.assert_array_equal(want[1][:3], [[5, 5, -1, -1, 4, 4, 0, 0],
                                                [4, 0, 0, 1, 1, 2, 1, 2],
                                                [2, 1, 0, 0, 1, 1, 1, 0]])
    np.testing.assert_array_equal(want, probe_ref["gemm"][:2])
    eng = CoocEngine(_ctx(PROBE_DOCS, PROBE_V, None), device="cpu",
                     method="gemm", **PROBE_PLAN)
    futs = [eng.submit((1,)), eng.submit((5,))]
    for f, w in zip(futs, want):
        np.testing.assert_array_equal(_slots(f.result().network), w)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("method", METHODS)
def test_bfs_and_engine_answer_a_seed_past_the_vocab(method, mesh,
                                                     probe_ref):
    """Seeds V and V + 3 alone and beside good ones: ``bfs_construct_batch``
    and ``bfs_construct``, and the engine, where the good requests of a
    batch that holds a bad one are answered too, and a later one."""
    want = probe_ref[method]
    ctx = _ctx(PROBE_DOCS, PROBE_V, mesh)
    got = T.bfs_construct_batch(ctx, torch.from_numpy(PROBE_SEEDS),
                                method=method, **PROBE_PLAN)
    np.testing.assert_array_equal(_per_query(got, len(PROBE_SEEDS)), want)
    np.testing.assert_array_equal(
        _slots(T.bfs_construct(ctx, torch.from_numpy(PROBE_SEEDS[2]),
                               method=method, **PROBE_PLAN)), want[2])
    eng = CoocEngine(ctx, device="cpu", method=method, q_batch=4,
                     **PROBE_PLAN)
    futs = [eng.submit(_spec(r)) for r in PROBE_SEEDS[:5]]
    for f, w in zip(futs, want[:5]):
        np.testing.assert_array_equal(_slots(f.result().network), w)
    np.testing.assert_array_equal(   # the engine goes on serving
        _slots(eng.submit(_spec(PROBE_SEEDS[5])).result().network), want[5])


@pytest.mark.parametrize("mesh", MESHES)
def test_server_lane_answers_a_bad_seed_and_keeps_serving(mesh, probe_ref):
    """One lane takes requests that mix seeds V and V + 3 with good ones
    under all four methods: every response is ok and equal to the
    reference's answer, and a later query on the same lane is answered."""
    ctx = _ctx(PROBE_DOCS, PROBE_V, mesh)
    reqs = [(m, i) for m in METHODS for i in (0, 1, 2, 6)]

    async def go():
        server = CoocServer(ctx, tenants=[TenantConfig("t")],
                            config=ServerConfig(q_batch=8, linger_ms=20.0,
                                                default_deadline_ms=60000.0,
                                                **PROBE_PLAN))
        await server.start()
        first = await asyncio.wait_for(asyncio.gather(*[
            server.submit("t", dict(seeds=list(_spec(PROBE_SEEDS[i])),
                                    method=m)) for m, i in reqs]), 60.0)
        later = await asyncio.wait_for(
            server.submit("t", list(_spec(PROBE_SEEDS[5]))), 60.0)
        await server.stop()
        return first, later

    first, later = asyncio.run(go())
    for (m, i), resp in zip(reqs, first):
        assert resp.ok, (m, i, resp.status, resp.reason)
        np.testing.assert_array_equal(_slots(resp.result.network),
                                      probe_ref[m][i])
    assert later.ok
    np.testing.assert_array_equal(_slots(later.result.network),
                                  probe_ref["gemm"][5])


def test_random_differential_with_seeds_past_the_vocab():
    """30 random corpora (V = 29, 60 docs) x the four methods, each batch's
    seeds drawn from [-1, V + 3] with V and V + 3 forced into it: 0
    mismatches in 120 method runs (36 on the tree before this repair)."""
    v, plan = 29, dict(depth=2, topk=4, beam=4)
    ref = {m: _jit_bfs(m, plan) for m in METHODS}
    mismatches = 0
    for case in range(30):
        rng = np.random.default_rng(100 + case)
        docs = [rng.integers(0, v, rng.integers(1, 8)).tolist()
                for _ in range(60)]
        seeds = rng.integers(-1, v + 4, (4, 3)).astype(np.int32)
        seeds[case % 4, 0], seeds[(case + 1) % 4, 1] = v, v + 3
        j_idx = J.pack_docs(docs, v)
        ctx = T.QueryContext.from_docs(docs, v, device="cpu")
        for m in METHODS:
            want = ref[m](j_idx, jnp.asarray(seeds))
            got = T.bfs_construct_batch(ctx, torch.from_numpy(seeds),
                                        method=m, **plan)
            mismatches += not np.array_equal(_slots(got), _slots(want))
    assert mismatches == 0


# ---------------------------------------------------------------------------
# 2. term_postings / and_term
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [5, 7, -6, -100])
def test_term_postings_and_and_term_clamp_as_the_reference(t):
    docs = [[0, 1, 2], [1, 2, 3], [0, 3], [2, 4], [0, 1, 4]] * 8
    j_idx = J.pack_docs(docs, 5)
    idx = T.pack_docs(docs, 5, device="cpu")
    want = np.asarray(J.term_postings(j_idx, jnp.int32(t)))
    got = T.to_uint32(T.term_postings(idx, t))
    np.testing.assert_array_equal(got, want)
    mask = T.term_postings(idx, 1)
    np.testing.assert_array_equal(
        T.to_uint32(T.and_term(idx, mask, t)),
        np.asarray(J.and_term(j_idx, J.term_postings(j_idx, jnp.int32(1)),
                              jnp.int32(t))))


# ---------------------------------------------------------------------------
# 3-4. LM tokens and labels
# ---------------------------------------------------------------------------


def _reference_tree(tree):
    """A port module's reference-layout weights as JAX arrays."""
    return jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), tree)


def _reference_server(jcfg, params, **kw):
    """The reference's ``DecodeServer``, each decode step waited for (see
    ``test_torch_lm_serving.py``: its ``step`` advances the positions it
    handed to an asynchronous decode)."""
    srv = JS.DecodeServer(jcfg, params, **kw)
    decode = srv._decode
    srv._decode = lambda *a: jax.block_until_ready(decode(*a))
    return srv


class _LM:
    """One arch at the reference's ``reduced_config``: the port's model,
    weights drawn from a seeded generator, and the same weights in the
    reference's layout; one reference server of 2 slots and 16 positions,
    reused (its compiled steps too)."""

    def __init__(self, arch):
        self.jcfg = reduced_config(JC.get_config(arch))
        self.cfg = TC.replace(TC.get_config(arch), **{
            f: getattr(self.jcfg, f) for f in self.jcfg.__dataclass_fields__
            if f != "shapes"})
        self.model = TT.init_params(self.cfg, torch.Generator().manual_seed(0),
                                    device="cpu", dtype=torch.float32)
        self.params = _reference_tree(TT.params_to_reference(self.cfg,
                                                             self.model))
        self.jsrv = _reference_server(self.jcfg, self.params, slots=2,
                                      max_len=16)

    def reference_streams(self, prompts, n_new):
        """Streams in submission order (rids continue across calls)."""
        self.jsrv.finished.clear()
        rids = [self.jsrv.submit(p, max_new_tokens=n_new) for p in prompts]
        got = {r.rid: r.out_tokens for r in self.jsrv.run_until_drained()}
        return [got[r] for r in rids]

    def port_streams(self, prompts, n_new):
        srv = DecodeServer(self.cfg, self.model, slots=2, max_len=16,
                           device="cpu")
        rids = [srv.submit(p, max_new_tokens=n_new) for p in prompts]
        got = {r.rid: r.out_tokens for r in srv.run_until_drained()}
        return [got[r] for r in rids]


@pytest.fixture(scope="module")
def lms():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _LM(arch)
        return cache[arch]
    return get


def test_decode_server_streams_with_a_bad_token(lms):
    """The recorded probe, llama at ``reduced_config`` (vocab 512): slots
    2, prompts [4, 5, 6] and [1, 2, t, 3] for t = 512, 517 and -513.  The
    reference's answer (the NaN row argmaxes to 0), and the good stream
    equal to a run without the bad prompt."""
    lm = lms("llama3-8b")
    alone = lm.port_streams([[4, 5, 6]], 3)
    for bad in (512, 517, -513):
        prompts = [[4, 5, 6], [1, 2, bad, 3]]
        got = lm.port_streams(prompts, 3)
        assert got == lm.reference_streams(prompts, 3), bad
        assert got[1] == [0, 0, 0] and got[0] == alone[0]


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-lite-16b"])
def test_decode_server_reuses_the_bad_prompts_slot(arch, lms):
    """Six requests through 2 slots, the second with a token past the
    vocab: a later request takes that slot, and every stream equals the
    reference's; the good streams equal those of a run without the bad
    request.  deepseek routes the NaN token's MoE choices (``top_k`` over
    NaN probabilities) beside the good ones, dropless."""
    lm = lms(arch)
    rng = np.random.default_rng(3)
    toks = lm_batch(lm.cfg, 6, 8, step=3)["tokens"]
    prompts = [toks[i, :int(rng.integers(2, 9))].tolist() for i in range(6)]
    prompts[1][1] = lm.cfg.padded_vocab + 7
    got = lm.port_streams(prompts, 4)
    assert got == lm.reference_streams(prompts, 4)
    assert got[1] == [0, 0, 0, 0]
    clean = lm.port_streams(prompts[:1] + prompts[2:], 4)
    assert got[:1] + got[2:] == clean


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-lite-16b"])
def test_prefill_and_decode_logits_with_bad_tokens(arch, lms):
    """NaN exactly in the reference's rows: prefill over a batch with a
    token past each end, then one decode step with bad tokens."""
    lm = lms(arch)
    cfg = lm.cfg
    toks = lm_batch(cfg, 3, 6, step=1)["tokens"].astype(np.int32)
    toks[1, 2] = cfg.vocab_size * 3
    toks[2, 0] = -cfg.padded_vocab - 1
    jl, jcache = JT.prefill(lm.jcfg, lm.params, jnp.asarray(toks), max_len=8)
    tl, tcache = TT.prefill(cfg, lm.model, torch.from_numpy(toks), max_len=8)
    _same_nan(tl, jl, rtol=1e-4, atol=1e-4)
    step = np.asarray([3, cfg.padded_vocab + 1, -1], np.int32)
    jl2, _ = JT.decode_step(lm.jcfg, lm.params, jcache, jnp.asarray(step))
    tl2, _ = TT.decode_step(cfg, lm.model, tcache, torch.from_numpy(step))
    _same_nan(tl2, jl2, rtol=1e-4, atol=1e-4)
    assert np.isnan(tl2[1].numpy()).all() and np.isnan(tl2[2].numpy()).all()
    assert np.isfinite(tl2[0].numpy()).all()


def test_lm_loss_with_labels_out_of_range(lms):
    lm = lms("llama3-8b")
    b = lm_batch(lm.cfg, 2, 8, step=0)
    for label, finite in ((-1, True), (lm.cfg.padded_vocab, False)):
        bb = {k: v.copy() for k, v in b.items()}
        bb["labels"][0, 3] = label
        want, _ = JT.loss_fn(lm.jcfg, lm.params, {k: jnp.asarray(v)
                                                  for k, v in bb.items()})
        got = float(TT.loss_fn(lm.cfg, lm.model, {
            k: torch.from_numpy(v) for k, v in bb.items()})[0].detach())
        assert np.isfinite(got) == finite
        _same_nan(np.asarray(got), np.asarray(float(want)), rtol=RTOL,
                  atol=ATOL)


# ---------------------------------------------------------------------------
# 5-7. recommenders
# ---------------------------------------------------------------------------

SEQ = ("sasrec", "bert4rec")


ARCHS = ("deepfm", "dlrm-rm2") + SEQ


@pytest.fixture(scope="module")
def recsys():
    """arch -> (jcfg, reference weights, cfg, model): the reference's
    ``reduced_config`` (1,000 rows per field or items), weights drawn by
    the port and carried to the reference's layout."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = reduced_config(JC.get_config(arch))
            cfg = TC.replace(TC.get_config(arch), vocab_per_field=1000,
                             n_items=1000, seq_len=jcfg.seq_len)
            model = R.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
            params = _reference_tree(R.params_to_reference(cfg, model))
            cache[arch] = jcfg, params, cfg, model
        return cache[arch]
    return get


def _tol(arch):
    return dict(rtol=1e-4 if arch == "dlrm-rm2" else RTOL, atol=ATOL)


def _bad_batch(arch, cfg, n=12):
    """A batch with ids past both ends and ones that wrap, each in its own
    sample."""
    b = recsys_batch(cfg, n, 1, seed=0)
    if arch in SEQ:
        rows = cfg.n_items + 2
        b["candidates"] = np.random.default_rng(5).integers(
            0, cfg.n_items, (n, 20)).astype(np.int32)
        b["seq"][1, 4] = 10 ** 6
        b["seq"][2, -1] = -1
        b["candidates"][3, 7] = rows + 3
        b["candidates"][4, 0] = -rows - 1
        b["candidates"][5, 2] = -2
    else:
        rows = cfg.n_sparse * cfg.vocab_per_field
        b["sparse_ids"][1, 0] = 10 ** 6
        b["sparse_ids"][2, 3] = -1                  # wraps into a row
        b["sparse_ids"][3, 0] = cfg.vocab_per_field + 3   # another field's row
        b["sparse_ids"][4, -1] = cfg.vocab_per_field  # one past the table
        b["sparse_ids"][5, 0] = -rows - 1
    return b


def _reference(fn, jcfg, params, b):
    return jax.jit(lambda p, bb: fn(jcfg, p, bb))(
        params, {k: jnp.asarray(v) for k, v in b.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_fn_with_bad_ids(recsys, arch):
    jcfg, params, cfg, model = recsys(arch)
    b = _bad_batch(arch, cfg)
    want = _reference(JR.serve_fn, jcfg, params, b)
    _same_nan(R.serve_fn(cfg, model, R.as_batch(b, "cpu")), want, **_tol(arch))
    nan_rows = np.isnan(np.asarray(want)).reshape(12, -1).any(axis=1)
    assert nan_rows.any() and not nan_rows.all()


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_fn_with_bad_ids(recsys, arch):
    jcfg, params, cfg, model = recsys(arch)
    if arch in SEQ:
        rng = np.random.default_rng(6)
        b = {"seq": rng.integers(0, cfg.n_items, (1, cfg.seq_len)).astype(
                 np.int32),
             "candidates": rng.integers(0, cfg.n_items, (40,)).astype(
                 np.int32)}
        b["candidates"][[3, 9, 17]] = [cfg.n_items + 2, -1, -10 ** 6]
    else:
        b = _bad_batch(arch, cfg)
    want = _reference(JR.retrieval_fn, jcfg, params, b)
    _same_nan(R.retrieval_fn(cfg, model, R.as_batch(b, "cpu")), want,
              **_tol(arch))
    assert np.isnan(np.asarray(want)).any()


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_with_bad_ids(recsys, arch):
    """The loss value under a graph (DLRM and DeepFM gather NaN rows there)
    and without one (a clamped row, the logit set to NaN)."""
    jcfg, params, cfg, model = recsys(arch)
    b = _bad_batch(arch, cfg)
    if arch in SEQ:
        b["pos"][0, 1], b["neg"][6, 2] = 10 ** 6, -1
    want = float(_reference(lambda c, p, bb: JR.loss_fn(c, p, bb)[0], jcfg,
                            params, b))
    got = R.loss_fn(cfg, model, R.as_batch(b, "cpu"))[0]
    with torch.no_grad():
        served = R.loss_fn(cfg, model, R.as_batch(b, "cpu"))[0]
    assert got.requires_grad and np.isnan(want)
    for v in (got, served):
        _same_nan(np.asarray(float(v.detach())), np.asarray(want),
                  **_tol(arch))


@pytest.mark.parametrize("arch", SEQ)
def test_sequence_nan_reaches_what_the_references_reaches(recsys, arch):
    """SASRec (causal) and BERT4Rec: an id past the table in one sequence
    position; the encoder's NaN positions equal the reference's, and so do
    those of attention over a NaN key and a NaN value, chunked and
    unchunked (the mask's ``where`` before the softmax, then 0 x NaN in
    the value product)."""
    jcfg, params, cfg, model = recsys(arch)
    seq = np.random.default_rng(7).integers(
        0, cfg.n_items, (3, cfg.seq_len)).astype(np.int32)
    seq[0, 5] = 10 ** 6
    causal = arch == "sasrec"
    want = JR._seq_encode(jcfg, params, jnp.asarray(seq), causal=causal)
    got = R._seq_encode(cfg, model, torch.from_numpy(seq), causal=causal)
    _same_nan(got, want, rtol=RTOL, atol=ATOL)
    from repro.models.layers import attention as j_attention
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((2, 8, 4, 8)).astype(np.float32)
               for _ in range(3))
    k[0, 5], v[1, 2] = np.nan, np.nan
    for chunk in (0, 4):
        want = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, q_chunk=chunk)
        got = L.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, q_chunk=chunk)
        _same_nan(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_embedding_bags_with_bad_ids(combiner):
    rng = np.random.default_rng(9)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    ids = rng.integers(0, 50, (4, 3, 5)).astype(np.int32)
    ids[0, 1, 2], ids[2, 0, 0], ids[3, 2, 4] = 50, -1, -51
    want = JR.embedding_bag(jnp.asarray(table), jnp.asarray(ids), combiner)
    got = R.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                          combiner=combiner)
    _same_nan(got, want, rtol=RTOL, atol=ATOL)
    flat = np.asarray([0, 1, 70, 7, 3, -2, 12, 41, 2, 5, 6], np.int32)
    seg = np.asarray([0, 0, 1, 1, 1, 3, 3, 9, 4, -1, 5], np.int32)
    want = JR.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(flat),
                                   jnp.asarray(seg), 5, combiner)
    got = R.embedding_bag_ragged(torch.from_numpy(table),
                                 torch.from_numpy(flat),
                                 torch.from_numpy(seg), 5, combiner=combiner)
    _same_nan(got, want, rtol=RTOL, atol=ATOL)
    assert np.isnan(np.asarray(want)[1]).all()


# ---------------------------------------------------------------------------
# 4 and 8. GIN
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gin():
    """gin-tu (the reference's ``reduced_config`` is gin-tu itself), 16
    features and 5 classes, weights drawn by the port."""
    jcfg = reduced_config(JC.get_config("gin-tu"))
    cfg = TC.get_config("gin-tu")
    model = G.init_gin(cfg, torch.Generator().manual_seed(0), 16, 5,
                       device="cpu")
    return jcfg, _reference_tree(G.params_to_reference(cfg, model)), cfg, model


def _gin_graph():
    g = gnn_synthetic_graph(60, 240, 16, 5, seed=2)
    g["label_mask"] = np.ones(60, np.float32)
    return g


def _both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})


@pytest.mark.parametrize("where", ["src", "dst", "both", "wrap"])
def test_gin_forward_with_bad_edges(gin, where):
    """A source past the nodes sends a NaN row (reaching its destination
    and, layer by layer, its neighbours), a destination past them is
    dropped, and -1 wraps; NaN positions and the finite values as the
    reference's."""
    jcfg, params, cfg, model = gin
    g = _gin_graph()
    if where in ("src", "both"):
        g["edge_src"][7] = 60
    if where in ("dst", "both"):
        g["edge_dst"][11] = 60 + 3
    if where == "wrap":
        g["edge_src"][5], g["edge_dst"][9] = -1, -60
    jb, tb = _both(g)
    want = JG.gin_forward(jcfg, params, jb["x"], jb["edge_src"],
                          jb["edge_dst"])
    got = G.gin_forward(cfg, model, tb["x"], tb["edge_src"], tb["edge_dst"])
    _same_nan(got, want, rtol=RTOL, atol=ATOL)
    nan_nodes = np.isnan(np.asarray(want)).any(axis=1)
    assert nan_nodes.any() == (where in ("src", "both"))
    assert not nan_nodes.all()


def test_gin_node_loss_with_bad_labels_and_nan_logits(gin):
    """A label past the classes gives a NaN loss; -1 wraps to the last
    class; a node whose logits are NaN counts as a hit where the
    reference's ``argmax`` (the first NaN) equals its label."""
    jcfg, params, cfg, model = gin
    for case in ("wrap", "past", "nan"):
        g = _gin_graph()
        if case == "wrap":
            g["labels"][3] = -1
        elif case == "past":
            g["labels"][3] = 5
        else:
            g["edge_src"][7] = 60                # NaN logits downstream
            g["labels"][:] = 0
        jb, tb = _both(g)
        want, wm = JG.node_loss(jcfg, params, jb)
        got, gm = G.node_loss(cfg, model, tb)
        _same_nan(np.asarray(float(got.detach())), np.asarray(float(want)),
                  rtol=RTOL, atol=ATOL)
        assert float(gm["acc"]) == float(wm["acc"]), case
    nan_logits = torch.tensor([[1.0, float("nan"), 3.0, float("nan")],
                               [float("nan")] * 4, [0.0, 2.0, 2.0, 1.0]])
    np.testing.assert_array_equal(
        G._first_argmax(nan_logits).numpy(),
        np.asarray(jnp.argmax(jnp.asarray(nan_logits.numpy()), -1)))


def test_gin_graph_pooling_drops_a_bad_graph_id(gin):
    jcfg, params, cfg, model = gin
    rng = np.random.default_rng(4)
    b = {"x": rng.standard_normal((40, 16)).astype(np.float32),
         "edge_src": rng.integers(0, 40, 100).astype(np.int32),
         "edge_dst": rng.integers(0, 40, 100).astype(np.int32),
         "graph_id": np.repeat(np.arange(4), 10).astype(np.int32),
         "labels": rng.integers(0, 5, 4).astype(np.int32)}
    b["graph_id"][[3, 17, 30]] = [4, -1, 99]
    b["labels"][2] = 7
    jb, tb = _both(b)
    jh = JG.gin_forward(jcfg, params, jb["x"], jb["edge_src"], jb["edge_dst"])
    th = G.gin_forward(cfg, model, tb["x"], tb["edge_src"], tb["edge_dst"])
    _same_nan(G.graph_logits(cfg, model, th, tb["graph_id"], 4),
              JG.graph_logits(jcfg, params, jh, jb["graph_id"], 4),
              rtol=RTOL, atol=ATOL)
    want, wm = JG.graph_loss(jcfg, params, jb)
    got, gm = G.graph_loss(cfg, model, tb)
    _same_nan(np.asarray(float(got.detach())), np.asarray(float(want)),
              rtol=RTOL, atol=ATOL)
    assert float(gm["acc"]) == float(wm["acc"])
