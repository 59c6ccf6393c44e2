"""The port's hand-written CUDA kernels against their plain versions, on
the card, and the paths that run them (BFS methods, materialization, DLRM
serving, kernel 4 under autograd, training against the CPU).  Every test here needs a CUDA device and skips without one; the
file imports no jax, so it runs on a GPU host that has none:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from repro_torch.core import QueryContext, QuerySpec, construct  # noqa: E402
from repro_torch.core.inverted_index import from_uint32  # noqa: E402
from repro_torch.data import synthetic_csl  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from torch_operands import query_masks, structured_operand  # noqa: E402


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


def _masks(rng, kind, b, w, device, per_query=32, density=0.7):
    """(b, w) frontier masks: dense words, all zero, one nonzero word at
    W - 1, or query-structured (``per_query`` rows a query, nonzero only
    inside its seed support, 1% or 5% of the words)."""
    if kind == "dense":
        return _bits(rng, (b, w), device, density=density)
    if kind == "zeros":
        return torch.zeros((b, w), dtype=torch.int32, device=device)
    if kind == "edge":                      # one nonzero word at W - 1
        m = torch.zeros((b, w), dtype=torch.int32, device=device)
        m[b - 1, w - 1] = -0x7FFF0000
        return m
    frac = {"query1": 0.01, "query5": 0.05}[kind]
    return from_uint32(query_masks(rng, -(-b // per_query), per_query, w,
                                   frac)[:b], device)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dense", "query1", "query5", "zeros",
                                  "edge"])
@pytest.mark.parametrize("b,w,v", [
    (1, 1, 9), (37, 70, 515), (256, 300, 2049), (33, 129, 256),
    (256, 3001, 700)])
def test_postings_kernel_matches_plain(cuda, b, w, v, kind):
    rng = np.random.default_rng(b + w + v)
    masks = _masks(rng, kind, b, w, cuda)
    packed = _bits(rng, (w, v), cuda)
    before = ops.LAUNCHES["postings_counts"]
    got = ops.postings_counts(masks, packed)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["postings_counts"] == before + 1
    assert torch.equal(got, ref.postings_counts_ref(masks, packed))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 75, 256])   # 75: B not a tile multiple
@pytest.mark.parametrize("kind", ["dense", "query1", "query5", "zeros",
                                  "edge"])
def test_postings_compaction_matches_plain(cuda, b, kind):
    """The compaction launch lists each tile's active words as
    ``ref.active_words_ref`` does and stages the tile's mask words there."""
    from repro_torch.kernels import postings
    rows, w = postings.ROWS, 1000
    masks = _masks(np.random.default_rng(b), kind, b, w, cuda)
    words, n, staged = postings.active_words_cuda(masks)
    torch.cuda.synchronize()
    want_words, want_n = ref.active_words_ref(masks, rows)
    assert torch.equal(n, want_n)
    padded = torch.nn.functional.pad(masks, (0, 0, 0, (-b) % rows))
    for t in range(words.shape[0]):
        sel = words[t, :int(n[t])]
        assert torch.equal(sel, want_words[t, :int(n[t])])
        tile = padded[t * rows:(t + 1) * rows]
        assert torch.equal(staged[t, :int(n[t])], tile[:, sel.long()].T)


@pytest.mark.gpu
@pytest.mark.parametrize("q,b,v,w,k,dedup,kind", [
    (1, 5, 97, 7, 6, True, "dense"),        # ragged, pad columns
    (1, 3, 40, 3, 50, False, "dense"),      # k > V, dedup off
    (4, 16, 1000, 130, 16, True, "dense"),  # batch-major, several V tiles
    (2, 8, 300, 40, 200, True, "dense"),    # k near the 256-column tile
    (8, 32, 2000, 3001, 16, True, "query1"),  # 1% of the words nonzero
    (3, 32, 700, 1000, 16, True, "query5"),
    (2, 8, 300, 40, 16, True, "zeros"),     # no active word at all
    (5, 5, 600, 300, 16, True, "query5"),   # 4-row tiles straddle queries
    (2, 5, 700, 200, 300, True, "query5"),  # k = 300, above the tile
    (1, 8, 300, 5, 16, True, "ties"),       # identical columns: all tied
])
def test_level_step_kernel_matches_plain(cuda, q, b, v, w, k, dedup, kind):
    rng = np.random.default_rng(q * b * v)
    r = q * b
    packed = _bits(rng, (w, v), cuda)
    if kind == "ties":                      # every count of a row equal
        packed = packed[:, :1].repeat(1, v).contiguous()
    masks = _masks(rng, "dense" if kind == "ties" else kind, r, w, cuda,
                   per_query=b, density=0.8)
    terms = torch.from_numpy(rng.integers(-1, v, r)).to(cuda)
    valid = torch.from_numpy(rng.integers(0, 2, r).astype(bool)).to(cuda)
    visited = torch.from_numpy(rng.integers(0, 2, (q, v)).astype(bool)).to(cuda)
    before = ops.LAUNCHES["level_step"]
    got_w, got_i = ops.level_step(masks, packed, terms, valid, visited, v=v,
                                  k=k, dedup=dedup)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["level_step"] == before + 1
    k_eff = min(k, v)
    want_w, want_i = ref.level_step_ref(masks, packed, terms, valid, visited,
                                        v=v, k=k_eff, dedup=dedup)
    assert torch.equal(got_w[:, :k_eff], want_w)
    assert torch.equal(got_i[:, :k_eff], want_i)
    assert (got_w[:, k_eff:] == -1).all() and (got_i[:, k_eff:] == 0).all()


@pytest.mark.gpu
def test_level_step_kernel_reads_padded_packed_columns(cuda):
    """packed wider than v (columns past v are padding): they rank below
    every real column, as in the reference's padded artifact."""
    rng = np.random.default_rng(6)
    q, b, v, w = 2, 8, 300, 40
    packed = _bits(rng, (w, 320), cuda)
    masks = _bits(rng, (q * b, w), cuda)
    terms = torch.from_numpy(rng.integers(-1, v, q * b)).to(cuda)
    valid = torch.ones(q * b, dtype=torch.bool, device=cuda)
    visited = torch.ones((q, v), dtype=torch.bool, device=cuda)
    got = ops.level_step(masks, packed, terms, valid, visited, v=v, k=16)
    want = ref.level_step_ref(masks, packed, terms, valid, visited, v=v,
                              k=16, dedup=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[0] == -1).all() and (got[1] < v).all()


@pytest.mark.gpu
def test_kernels_on_a_real_index_match_plain(cuda):
    """Kernels 1 and 2, and kernel 1's compaction launch, on a real level-1
    frontier (8 queries of a 32-row beam from the most frequent terms of
    2^15 documents over 2^13 terms, after one "fused" level); kernel 3 on
    the index's first row group against the context's ``x_dense``."""
    from repro_torch.core import unpack_bitmap
    from repro_torch.core.cooccurrence import _expand_level, initial_state
    from repro_torch.core.materialize import GROUP
    from repro_torch.kernels import postings
    v, q = 1 << 13, 8
    ctx = QueryContext.from_docs(synthetic_csl(1 << 15, v, seed=1), v,
                                 device=cuda)
    df = ctx.index.doc_freq.cpu().numpy()
    seeds = np.argsort(-df, kind="stable")[:q].reshape(q, 1)
    st = initial_state(ctx.index, torch.from_numpy(seeds), beam=32)
    st, _ = _expand_level(ctx.index, st, q, 16, True, "fused",
                          ctx.operands("fused"))
    masks, packed = st.masks, ctx.index.packed
    assert masks.shape[0] == q * 32 and bool((masks != 0).any())
    assert torch.equal(ops.postings_counts(masks, packed),
                       ref.postings_counts_ref(masks, packed))
    words, n = postings.active_words_cuda(masks)[:2]
    want_words, want_n = ref.active_words_ref(masks, postings.ROWS)
    first = torch.arange(words.shape[1], device=cuda) < n[:, None]
    assert torch.equal(n, want_n)
    assert torch.equal(torch.where(first, words, -1), want_words)
    got = ops.level_step(masks, packed, st.terms, st.valid, st.visited, v=v,
                         k=16, dedup=True)
    want = ref.level_step_ref(masks, packed, st.terms, st.valid, st.visited,
                              v=v, k=16, dedup=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    xl = unpack_bitmap(ctx.packed_t_pad()[:GROUP * 128, :ctx.index.n_words],
                       torch.int8).t()
    paths = dict(ops.COOCCUR_PATHS)
    got = ops.cooccur_counts(xl, ctx.x_dense())
    torch.cuda.synchronize()
    assert ops.COOCCUR_PATHS["tma"] == paths["tma"] + 1
    assert torch.equal(got, ref.cooccur_counts_ref(xl, ctx.x_dense()))


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


def _incidence(rng, v, d, device, density=0.2):
    """(v, d) term-major 0/1 int8 storage on ``device``."""
    return torch.from_numpy((rng.random((v, d)) < density).astype(np.int8)
                            ).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("d,vl,vr,path", [
    (33, 17, 9, "bytes"),          # rows not 16-byte aligned: the fallback
    (300, 200, 100, "bytes"),      # the fallback, ragged M and N tiles
    (1024, 128, 256, "tma"),       # whole tiles
    (4160, 130, 1000, "tma"),      # ragged M and N, K not a stage multiple
    (32, 600, 300, "tma"),         # K below one 128-byte stage
    (416, 384, 700, "tma"),        # 3 row tiles: the cluster shrinks to 1
    (4096, 512, 2048, "tma"),      # a 4-block group: clusters of 4
    (2048, 1, 1, "tma"),           # one row, one column
])
def test_cooccur_kernel_matches_plain(cuda, d, vl, vr, path):
    rng = np.random.default_rng(d + vl + vr)
    xl = _incidence(rng, vl, d, cuda).t()
    xr = _incidence(rng, vr, d, cuda).t()
    before = ops.LAUNCHES["cooccur_counts"]
    paths = dict(ops.COOCCUR_PATHS)
    got = ops.cooccur_counts(xl, xr)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cooccur_counts"] == before + 1
    assert ops.COOCCUR_PATHS[path] == paths[path] + 1
    assert torch.equal(got, ref.cooccur_counts_ref(xl, xr))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [128, 512])
@pytest.mark.parametrize("kind", ["random", "identity", "ones"])
def test_cooccur_tma_path_matches_int_mm(cuda, m, kind):
    """The wgmma path at a row block (M = 128) and a group of four
    (M = 512) == torch._int_mm on the same operands, on random and on
    structured 0/1 operands."""
    rng = np.random.default_rng(m)
    d, n = 8192, 2304
    if kind == "random":
        a = _incidence(rng, m, d, cuda, 0.3)
        b = _incidence(rng, n, d, cuda, 0.3)
    else:
        a = structured_operand(kind, m, d, cuda)
        b = structured_operand(kind, n, d, cuda)
    paths = dict(ops.COOCCUR_PATHS)
    got = ops.cooccur_counts(a.t(), b.t())
    torch.cuda.synchronize()
    assert ops.COOCCUR_PATHS["tma"] == paths["tma"] + 1
    assert torch.equal(got, torch._int_mm(a, b.t()))


@pytest.mark.gpu
def test_cooccur_kernel_ragged_k_inside_aligned_rows(cuda):
    """K = 50 docs inside rows 64 bytes apart: the 16-byte copies must read
    only the 50 docs (the bytes past K in each row are nonzero here)."""
    rng = np.random.default_rng(8)
    a = torch.ones((70, 64), dtype=torch.int8, device=cuda)
    b = torch.ones((300, 64), dtype=torch.int8, device=cuda)
    a[:, :50] = _incidence(rng, 70, 50, cuda, 0.5)
    b[:, :50] = _incidence(rng, 300, 50, cuda, 0.5)
    xl, xr = a[:, :50].t(), b[:, :50].t()
    got = ops.cooccur_counts(xl, xr)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.cooccur_counts_ref(xl, xr))


@pytest.mark.gpu
def test_materialize_methods_agree_on_the_card(cuda):
    """The whole-corpus network through the kernel equals the registry
    methods' on the card, scoped and unscoped."""
    from repro_torch.core import materialize
    from repro_torch.core.materialize import GROUP
    docs = synthetic_csl(3000, 700, seed=4)
    ctx = QueryContext.from_docs(docs, 700, device=cuda)
    ctx.tag_scope("half", np.arange(0, 3000, 2))
    for scope in (None, "half"):
        before = ops.LAUNCHES["cooccur_counts"]
        want = materialize(ctx, k=8, method="pallas", scope=scope)
        assert ops.LAUNCHES["cooccur_counts"] == before + -(-700 // (
            GROUP * 128))
        for method in ("gemm", "popcount", "fused"):
            net = materialize(ctx, k=8, method=method, scope=scope)
            for a, b in zip(net, want):
                assert torch.equal(a, b), (method, scope)


@pytest.mark.gpu
def test_compacted_network_on_the_card(cuda):
    """The "pallas" network, each row group counted over its own docs
    only, equals "gemm"'s on the card, scoped and unscoped; each masks
    span carries its group's union, computed here from the docs."""
    from repro_torch import tracing
    from repro_torch.core import materialize
    from repro_torch.core.materialize import GROUP
    n, v = 20_000, 8192
    step = GROUP * 128
    docs = synthetic_csl(n, v, seed=9)
    ctx = QueryContext.from_docs(docs, v, device=cuda)
    half = np.arange(0, n, 2)
    ctx.tag_scope("half", half)
    nets = {}
    for scope, rows in ((None, range(n)), ("half", half)):
        held = np.zeros((n, v // step), dtype=bool)
        for i in rows:
            held[i, np.asarray(docs[i], dtype=np.int64) // step] = True
        unions = held.sum(0).tolist()
        before = ops.LAUNCHES["cooccur_counts"]
        tracing.clear()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            nets[scope] = materialize(ctx, k=16, method="pallas",
                                      scope=scope)
            torch.cuda.synchronize()
        got = [s[4]["docs"] for s in tracing.spans()
               if s[0] == "cooc.materialize.masks"]
        tracing.clear()
        assert got == unions, scope
        assert ops.LAUNCHES["cooccur_counts"] == before + sum(
            u > 0 for u in unions)
    assert ctx.unpack_count == 0
    for scope, net in nets.items():
        want = materialize(ctx, k=16, method="gemm", scope=scope)
        for a, b in zip(net, want):
            assert torch.equal(a, b), scope


@pytest.mark.gpu
def test_chunked_network_on_the_card(cuda, monkeypatch):
    """Over MeSH's 30,454 terms (a short last group, ragged column tiles),
    with head groups of several document chunks: the "pallas" network
    equals "gemm"'s, its rows equal the plain count's top-k, and each
    chunk is one launch."""
    import importlib
    from repro_torch.core import materialize
    mat = importlib.import_module("repro_torch.core.materialize")
    chunk = 1 << 15
    monkeypatch.setattr(mat, "DOC_CHUNK", chunk)
    n, v, k = 100_000, 30_454, 16
    docs = synthetic_csl(n, v, seed=11)
    ctx = QueryContext.from_docs(docs, v, device=cuda)
    step = mat.GROUP * 128
    held = np.zeros((n, -(-v // step)), dtype=bool)
    for i, d in enumerate(docs):
        held[i, np.asarray(d, dtype=np.int64) // step] = True
    unions = held.sum(0)
    assert unions[0] > 2 * chunk and v % step
    before = ops.LAUNCHES["cooccur_counts"]
    net = materialize(ctx, k=k, method="pallas")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cooccur_counts"] - before == sum(
        -(-int(u) // chunk) for u in unions)
    assert ctx.unpack_count == 0
    want = materialize(ctx, k=k, method="gemm")
    for a, b in zip(net, want):
        assert torch.equal(a, b)
    rows = torch.tensor([0, 1, 2, 511, 512, 5000, v - 1], device=cuda)
    x = ctx.x_dense()[:, :v]
    counts = ref.cooccur_counts_ref(x[:, rows].contiguous(), x).cpu()
    counts[torch.arange(len(rows)), rows.cpu()] = -1
    order = torch.sort(-counts, dim=1, stable=True).indices[:, :k]
    top = torch.gather(counts, 1, order)
    slots = (rows.cpu()[:, None] * k + torch.arange(k)).reshape(-1)
    got_w = net.weight.cpu()[slots].reshape(-1, k)
    got_d = net.dst.cpu()[slots].reshape(-1, k)
    assert torch.equal(got_w, torch.where(top > 0, top, 0).to(got_w.dtype))
    assert torch.equal(got_d, torch.where(top > 0, order, -1).to(
        got_d.dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("c", [64, 256, 4096])
def test_postings_kernel_on_approx_operands(cuda, c):
    """Kernel 1 on the approximate sweep's operands: 128 postings rows
    (dense head rows and sparse tail rows) against C gathered candidate
    columns, the pad columns zeroed."""
    from repro_torch.core import sketch
    v = 8192
    ctx = QueryContext.from_docs(synthetic_csl(20_000, v, seed=6), v,
                                 device=cuda)
    df = ctx.index.doc_freq.cpu().numpy()
    order = np.argsort(-df, kind="stable")
    live = order[df[order] > 0]
    rows = torch.from_numpy(np.concatenate([live[:64], live[-64:]]))
    masks = ctx.packed_t_pad()[rows.to(cuda), :ctx.index.n_words]
    rng = np.random.default_rng(c)
    cand = sketch.pad_candidates(
        np.sort(rng.choice(v, c * 3 // 4, replace=False)), v)
    cand = torch.from_numpy(cand).to(cuda)
    sub = ctx.index.packed.index_select(1, cand.clamp(min=0))
    sub[:, cand < 0] = 0
    assert torch.equal(ops.postings_counts(masks, sub),
                       ref.postings_counts_ref(masks, sub))


@pytest.mark.gpu
def test_approx_methods_agree_on_the_card_and_with_the_cpu(cuda):
    """mode="approx" through kernel 1 ("pallas") equals "gemm"
    (``torch._int_mm``) on the card and the port's plain versions on the
    CPU, slot for slot, with the same estimate and stats."""
    from repro_torch.core import materialize
    docs = synthetic_csl(6000, 2048, seed=7)
    nets = {}
    for dev in (cuda, torch.device("cpu")):
        ctx = QueryContext.from_docs(docs, 2048, device=dev)
        for method in ("pallas", "gemm"):
            before = ops.LAUNCHES["postings_counts"]
            nets[dev.type, method] = materialize(ctx, k=8, mode="approx",
                                                 method=method)
            if (dev.type, method) == ("cuda", "pallas"):
                assert ops.LAUNCHES["postings_counts"] > before
    want = nets["cpu", "pallas"]
    assert want.num_edges() > 0
    for key, net in nets.items():
        for a, b in zip(net[:4], want[:4]):
            assert torch.equal(a.cpu(), b), key
        assert (net.recall_estimate, net.stats) == (want.recall_estimate,
                                                    want.stats), key


@pytest.mark.gpu
def test_snapshot_round_trip_on_the_card(cuda, tmp_path):
    """A windowed index with a cold tier and sketches, saved on the card
    and loaded back onto the card and onto the CPU: the same bits, the
    same answers, no block rehashed."""
    from repro_torch.api import CoocIndex
    from repro_torch.core import sketch
    texts = [" ".join(f"w{t}" for t in d)
             for d in synthetic_csl(900, 300, seed=8)]
    idx = CoocIndex(device=cuda, window=400, cold_store={}, method="fused")
    for lo in range(0, 900, 150):
        idx.add_documents(texts[lo:lo + 150], timestamp=float(lo))
    idx.ctx.term_signatures(num_perm=32)
    idx.save(str(tmp_path / "snap"))
    on_card = CoocIndex.load(str(tmp_path / "snap"), device=cuda)
    on_cpu = CoocIndex.load(str(tmp_path / "snap"), device="cpu")
    assert torch.equal(on_card.ctx.index.packed, idx.ctx.index.packed)
    hashed = sketch.block_signatures
    try:
        sketch.block_signatures = None      # a rehash would raise
        assert torch.equal(on_card.ctx.term_signatures(num_perm=32),
                           idx.ctx.term_signatures(num_perm=32))
    finally:
        sketch.block_signatures = hashed
    seed = idx.lexicon.id_to_term[int(torch.argmax(idx.ctx.index.doc_freq))]
    for other in (on_card, on_cpu):
        for method in ("fused", "pallas", "gemm"):
            assert (other.network([seed], method=method)
                    == idx.network([seed], method=method)), method
        for kw in ({}, {"scope": "all-time"}, {"mode": "approx"}):
            assert other.full_network(k=4, **kw) == idx.full_network(
                k=4, **kw), kw


def _normal(rng, shape, device, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(device=device, dtype=dtype)


# fp32 sums in another order: 1e-5 (the reference's tolerance); bf16 output
# rounded from fp32 sums that may differ in the last bit: one bf16 step
_DOT_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


_DOT_SHAPES = [
    (128, 27, 64, torch.float32, 0), (37, 27, 64, torch.float32, 0),
    (1, 27, 64, torch.float32, 0),
    (64, 8, 16, torch.float32, 0), (256, 40, 10, torch.float32, 0),
    (1001, 64, 256, torch.float32, 0),   # fewer samples a CTA
    (37, 27, 64, torch.bfloat16, 0), (5, 27, 63, torch.bfloat16, 0),
    (3, 2, 1, torch.float32, 0),
    # the DLRM cells' interaction input: serve_p99 and serve_bulk
    (512, 27, 64, torch.float32, 0), (512, 27, 64, torch.bfloat16, 0),
    (513, 27, 64, torch.bfloat16, 0),
    (262_144, 27, 64, torch.float32, 0), (262_144, 27, 64, torch.bfloat16, 0),
    # both sides of the plan's switches on 132 SMs: past one wave of one
    # CTA a SM (528 samples), to the persistent ring past 3 CTAs a SM (1,584)
    (528, 27, 64, torch.float32, 0), (529, 27, 64, torch.float32, 0),
    (1584, 27, 64, torch.float32, 0), (1585, 27, 64, torch.float32, 0),
    (1585, 27, 64, torch.bfloat16, 0),
    # x one element into its buffer: the plain load path
    (512, 27, 64, torch.float32, 1), (1585, 27, 64, torch.bfloat16, 1),
    (300, 27, 64, torch.bfloat16, 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,e,dtype,offset", _DOT_SHAPES)
def test_dot_interaction_kernel_matches_plain(cuda, b, f, e, dtype, offset):
    rng = np.random.default_rng(b + f + e)
    buf = _normal(rng, (b * f * e + offset,), cuda, dtype)
    x = buf[offset:].view(b, f, e)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    before = ops.LAUNCHES["dot_interaction"]
    got = ops.dot_interaction(x)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dot_interaction"] == before + 1
    assert got.dtype == dtype and got.shape == (b, f * (f - 1) // 2)
    want = ref.dot_interaction_ref(x)
    tol = _DOT_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,f,e,dtype,offset", _DOT_SHAPES)
def test_dot_interaction_autograd_matches_plain_gradient(cuda, b, f, e, dtype,
                                                         offset):
    """Kernel 4 under autograd (``ops.DotInteraction``): one launch a
    forward pass, and x's gradient == autograd's through the plain
    forward, within the forward's tolerance of the gradient's scale."""
    rng = np.random.default_rng(b + f + e + 1)
    buf = _normal(rng, (b * f * e + offset,), cuda, dtype)
    x = buf[offset:].view(b, f, e).requires_grad_(True)
    w = _normal(rng, (b, f * (f - 1) // 2), cuda, torch.float32)
    before = ops.LAUNCHES["dot_interaction"]
    got, = torch.autograd.grad(torch.sum(ops.dot_interaction(x).float() * w),
                               x)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dot_interaction"] == before + 1
    xp = x.detach().clone().requires_grad_(True)
    want, = torch.autograd.grad(
        torch.sum(ref.dot_interaction_ref(xp).float() * w), xp)
    assert got.dtype == dtype and got.shape == x.shape
    tol = _DOT_TOL[dtype]
    scale = max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dlrm-rm2", "deepfm", "sasrec", "bert4rec",
                                  "gin-tu", "llama3-8b", "granite-3-8b",
                                  "qwen1.5-32b", "deepseek-v2-lite-16b",
                                  "kimi-k2-1t-a32b"])
def test_train_on_the_card_matches_the_cpu(cuda, arch, monkeypatch):
    """``train()`` at the reference's reduced_config on the card and on the
    CPU from one step-0 checkpoint: losses and step-3 weights within
    chip_smoke's TRAIN_CPU_TOL."""
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    monkeypatch.setattr(chip_smoke, "TRAIN_ARCHS", [arch])
    chip_smoke._train_card_against_cpu(cuda)


def _decode_inputs(rng, b, hq, hkv, d, s, device, dtype):
    q = _normal(rng, (b, hq, d), device, dtype)
    k = _normal(rng, (b, s, hkv, d), device, dtype)
    v = _normal(rng, (b, s, hkv, d), device, dtype)
    ln = rng.integers(1, s + 1, (b,)).astype(np.int32)
    if b >= 3:                              # the length-0 rule, length 1
        ln[:2] = 0, 1
    if b >= 4:                              # inside a 64-row tile
        ln[2] = min(s, 64 * (s // 128) + 37)
    return q, k, v, torch.from_numpy(ln).to(device)


def _assert_decode_close(got, want, dtype):
    """fp32: 2e-5 abs + rel.  bf16: ``chip_smoke.py``'s rule, one bf16 step
    of the output (2^-7 |want|) plus 1e-3 of the row's rms: both sides sum
    in fp32 and round once."""
    w = want.float()
    err = (got.float() - w).abs()
    if dtype == torch.bfloat16:
        rms = w.pow(2).mean(dim=(1, 2), keepdim=True).sqrt()
        lim = 2.0 ** -7 * w.abs() + 1e-3 * rms
    else:
        lim = 2e-5 + 2e-5 * w.abs()
    assert torch.isfinite(got.float()).all()
    assert (err <= lim).all(), f"max abs err {float(err.max()):.3g}"


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,d,s,chunk", [
    (2, 8, 2, 64, 512, 128), (1, 4, 4, 32, 256, 64),
    (3, 16, 8, 128, 300, 128),          # S not a multiple of the tile
    (2, 8, 1, 64, 1024, 256),           # MQA
    (2, 32, 2, 256, 100, 64),           # G = 16, d = 256
    (3, 2, 1, 8, 33, 512),              # d = 8, chunk > S
    (1, 32, 8, 128, 20000, 512),        # one row split across many CTAs
    (4, 32, 8, 128, 4100, 512),         # lengths 0, 1, 2085 (mid-tile), more
    (3, 12, 4, 40, 130, 64),            # G = 3, d not a multiple of 16
    (2, 16, 2, 192, 700, 128),          # G = 8, 128 < d < 256
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(cuda, b, hq, hkv, d, s, chunk,
                                          dtype):
    rng = np.random.default_rng(b * s + d)
    q, k, v, ln = _decode_inputs(rng, b, hq, hkv, d, s, cuda, dtype)
    before = ops.LAUNCHES["flash_decode"]
    got = ops.flash_decode(q, k, v, ln, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_decode"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_decode_ref(q, k, v, ln, chunk=chunk)
    _assert_decode_close(got, want, dtype)


@pytest.mark.gpu
def test_new_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError):
        ops.dot_interaction(torch.zeros((2, 65, 8), device=cuda))
    with pytest.raises(TypeError):
        ops.dot_interaction(torch.zeros((2, 4, 8), dtype=torch.float16,
                                        device=cuda))
    with pytest.raises(ValueError):
        ops.dot_interaction(torch.zeros((2, 8, 4), device=cuda).mT)
    q = torch.zeros((1, 17, 8), device=cuda)
    kv = torch.zeros((1, 4, 1, 8), device=cuda)
    with pytest.raises(ValueError):                 # G = 17
        ops.flash_decode(q, kv, kv, 4)
    q = torch.zeros((1, 2, 12), device=cuda)
    kv = torch.zeros((1, 4, 1, 12), device=cuda)
    with pytest.raises(ValueError):                 # d = 12
        ops.flash_decode(q, kv, kv, 4)
    counts = torch.zeros((8, 300), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ops.row_top_k(counts.to(torch.int64), 0, 16)
    with pytest.raises(ValueError):                 # columns not contiguous
        ops.row_top_k(counts.t(), 0, 4)
    with pytest.raises(ValueError):
        ops.row_top_k(counts, 0, ops.ROW_TOPK_MAX_K + 1)


@pytest.mark.gpu
def test_dlrm_serving_on_the_card_matches_the_cpu(cuda):
    """The DLRM path on the card, through the kernel, equals the same
    weights on the CPU (plain interaction)."""
    from repro_torch.configs import get_config, replace
    from repro_torch.data import recsys_batch
    from repro_torch.models import recsys as R
    cfg = replace(get_config("dlrm-rm2"), vocab_per_field=1000)
    gen = torch.Generator(device="cpu").manual_seed(0)
    cpu_model = R.init_params(cfg, gen, device="cpu")
    model = R.DLRM(cfg, device=cuda)
    model.load_state_dict(cpu_model.state_dict())
    batch = recsys_batch(cfg, 300, 1)
    before = ops.LAUNCHES["dot_interaction"]
    got = R.serve_fn(cfg, model, R.as_batch(batch, cuda))
    assert ops.LAUNCHES["dot_interaction"] == before + 1
    want = R.serve_fn(cfg, cpu_model, R.as_batch(batch, "cpu"))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3-8b", "granite-3-8b",
                                  "qwen1.5-32b", "deepseek-v2-lite-16b",
                                  "kimi-k2-1t-a32b"])
def test_lm_serving_on_the_card_matches_the_cpu(cuda, arch):
    """The LM path at small widths (2 layers of d 128; the MoE archs 4
    experts top-2, MLA at rank 32), fp32: the same weights on the card
    and on the CPU give the same prefill and decode logits (rtol = atol =
    1e-4, fp32 sums in another order) and the same greedy streams through
    ``DecodeServer``; no hand-written kernel is launched."""
    from repro_torch.configs import get_config, replace
    from repro_torch.models import transformer as T
    from repro_torch.serve import DecodeServer
    cfg = get_config(arch)
    kw = dict(n_layers=2, d_model=128, n_heads=4, d_ff=256, vocab_size=500,
              attn_q_chunk=0, head_dim=32,
              n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4)
    if cfg.moe:
        kw.update(n_experts=4, top_k=2, d_ff_expert=64,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  first_dense_layers=1)
    if cfg.mla:
        kw.update(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                  v_head_dim=16)
    cfg = replace(cfg, **kw)
    torch.backends.cuda.matmul.allow_tf32 = False
    host = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                         dtype=torch.float32)
    card = T.LM(cfg, device=cuda, dtype=torch.float32)
    card.load_state_dict(host.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 9)).astype(np.int32))
    ops.reset_launches()
    got, cache = T.prefill(cfg, card, toks.to(cuda), max_len=12)
    want, hcache = T.prefill(cfg, host, toks, max_len=12)
    for _ in range(3):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(cache["kv"].cpu(), hcache["kv"],
                                   rtol=1e-4, atol=1e-4)
        nxt = want.argmax(-1).to(torch.int32)
        got, cache = T.decode_step(cfg, card, cache, nxt.to(cuda))
        want, hcache = T.decode_step(cfg, host, hcache, nxt)
    streams = []
    for model, dev in ((card, cuda), (host, "cpu")):
        srv = DecodeServer(cfg, model, slots=2, max_len=32, device=dev)
        for i in range(3):
            srv.submit(toks[i, :3 + 2 * i].tolist(), max_new_tokens=5)
        streams.append({r.rid: r.out_tokens for r in srv.run_until_drained()})
    assert streams[0] == streams[1]
    assert all(n == 0 for n in ops.LAUNCHES.values())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepfm", "sasrec", "bert4rec", "gin-tu"])
def test_side_models_on_the_card_match_the_cpu(cuda, arch):
    """The side models at the reference's reduced_config size (1,000 rows
    a field or items, sequences of at most 16; gin-tu as published), fp32:
    the same weights on the card and on the CPU give the same serving
    scores, retrieval scores and losses (GIN: node states with and without
    edge_mask, node and graph losses) within rtol = atol = 1e-4 (fp32 sums
    in another order, GIN's scatter-add by atomics on the card); no
    hand-written kernel is launched."""
    from repro_torch.configs import get_config, replace
    from repro_torch.data import gnn_synthetic_graph, recsys_batch
    from repro_torch.models import gnn as G
    from repro_torch.models import recsys as R
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    def close(a, b):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)

    ops.reset_launches()
    cfg = get_config(arch)
    if arch == "gin-tu":
        g = gnn_synthetic_graph(512, 2048, 32, 8, seed=0)
        g["edge_mask"] = (np.arange(2048) % 4 != 3).astype(np.float32)
        g["graph_id"] = (np.arange(512) // 64).astype(np.int32)
        host = G.init_gin(cfg, torch.Generator().manual_seed(0), 32, 8,
                          device="cpu")
        card = G.GIN(cfg, 32, 8, device=cuda)
        card.load_state_dict(host.state_dict())
        hb = {k: torch.from_numpy(v) for k, v in g.items()}
        cb = {k: v.to(cuda) for k, v in hb.items()}
        for mask in (None, "edge_mask"):
            close(G.gin_forward(cfg, card, cb["x"], cb["edge_src"],
                                cb["edge_dst"], cb.get(mask)),
                  G.gin_forward(cfg, host, hb["x"], hb["edge_src"],
                                hb["edge_dst"], hb.get(mask)))
        close(G.node_loss(cfg, card, cb)[0], G.node_loss(cfg, host, hb)[0])
        gl = dict(hb, labels=torch.arange(8, dtype=torch.int32) % 2)
        close(G.graph_loss(cfg, card, {k: v.to(cuda) for k, v in gl.items()}
                           )[0], G.graph_loss(cfg, host, gl)[0])
    else:
        cfg = replace(cfg, vocab_per_field=1000, n_items=1000,
                      seq_len=min(cfg.seq_len, 16))
        host = R.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        card = type(host)(cfg, device=cuda)
        card.load_state_dict(host.state_dict())
        b = recsys_batch(cfg, 64, 1)
        rng = np.random.default_rng(0)
        if arch == "deepfm":
            serve = retr = {"sparse_ids": b["sparse_ids"]}
        else:
            serve = {"seq": b["seq"], "candidates": rng.integers(
                0, 1000, (64, 100)).astype(np.int32)}
            retr = {"seq": b["seq"][:1],
                    "candidates": np.arange(1002, dtype=np.int32)}
        for fn, batch in ((R.serve_fn, serve), (R.retrieval_fn, retr),
                          (lambda c, m, x: R.loss_fn(c, m, x)[0], b)):
            close(fn(cfg, card, R.as_batch(batch, cuda)),
                  fn(cfg, host, R.as_batch(batch, "cpu")))
    assert all(n == 0 for n in ops.LAUNCHES.values())


def _mesh_matches_one_device(cuda, mesh):
    """Every method's batch and the whole network (both strategies, exact
    and approx) on ``mesh`` equal the unsharded context's on the card,
    with one kernel launch a level per shard, and kernel 3 takes its TMA
    path on the shards' operands."""
    from repro_torch.core import bfs_construct_batch, materialize
    n = mesh.size
    docs = synthetic_csl(4096, 1000, seed=6)
    ctx = QueryContext.from_docs(docs, 1000, device=cuda)
    mctx = QueryContext(ctx.index, device=cuda, mesh=mesh)
    seeds = torch.tensor([[3, 40], [7, -1], [999, 12], [0, -1]], device=cuda)
    plan = dict(depth=3, topk=8, beam=8)
    docs_mesh = mesh.shape["data"] > 1
    for method, counter in (("fused", "level_step"),
                            ("pallas", "postings_counts"),
                            ("gemm", None), ("popcount", None)):
        if docs_mesh and method == "fused":
            counter = "postings_counts"
        want = bfs_construct_batch(ctx, seeds, method=method, **plan)
        ops.reset_launches()
        got = bfs_construct_batch(mctx, seeds, method=method, **plan)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), method
        if counter is not None:
            assert ops.LAUNCHES[counter] == plan["depth"] * n, method
    want = materialize(ctx, k=8, method="pallas", use_cache=False)
    for strategy in ("rows", "cols"):
        ops.reset_launches()
        got = materialize(mctx, k=8, method="pallas", shard_strategy=strategy,
                          use_cache=False)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), strategy
        assert ops.COOCCUR_PATHS["bytes"] == 0 and ops.COOCCUR_PATHS["tma"]
    got = materialize(mctx, k=8, mode="approx", method="pallas",
                      num_perm=64, use_cache=False)
    want = materialize(ctx, k=8, mode="approx", method="pallas",
                       num_perm=64, use_cache=False)
    assert all(torch.equal(a, b) for a, b in zip(got[:4], want[:4]))
    assert got.stats == want.stats
    assert torch.equal(mctx.term_signatures(num_perm=64),
                       ctx.term_signatures(num_perm=64))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["terms", "docs"])
def test_mesh_on_the_card_matches_one_device(cuda, kind):
    """Four shards of the one card."""
    from repro_torch.core import make_cooc_mesh
    _mesh_matches_one_device(cuda, make_cooc_mesh(devices=[cuda] * 4,
                                                  shard=kind))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["terms", "docs"])
def test_mesh_across_cards_matches_one_device(cuda, kind):
    """One shard a card, over every visible card (the cross-device
    copies and merges)."""
    from repro_torch.core import make_cooc_mesh
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    _mesh_matches_one_device(torch.device("cuda", 0),
                             make_cooc_mesh(shard=kind))


# ---------------------------------------------------------------------------
# the launch layer on the card
def _row_counts(kind, r, v, device):
    """(r, v) int32 counts: each row ascending or descending in its
    columns, all equal, or Zipf-like (Poisson counts whose means fall with
    the column, as a co-occurrence row's do)."""
    g = torch.Generator(device=device).manual_seed(v + r)
    col = torch.arange(v, device=device, dtype=torch.int32)
    if kind == "ascending":
        return (col[None, :] + torch.arange(r, device=device,
                                            dtype=torch.int32)[:, None])
    if kind == "descending":
        return (v - col).expand(r, v).contiguous()
    if kind == "equal":
        return torch.full((r, v), 5, dtype=torch.int32, device=device)
    w = 1.0 / (col.double() + 2.7) ** 1.15
    scale = torch.rand((r, 1), generator=g, device=device,
                       dtype=torch.float64) * 2e5
    return torch.poisson(w[None, :] * scale, generator=g).to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ascending", "descending", "equal",
                                  "zipf"])
@pytest.mark.parametrize("k", [1, 16, 17, 64, 128])
@pytest.mark.parametrize("v", [65_536, 30_454])
def test_row_top_k_kernel_matches_plain(cuda, v, k, kind):
    """The row top-k kernel equals its plain version bit for bit on a row
    group's (512, V) counts at CSL's and MeSH's widths (rows of 30,454
    counts are not 16-byte aligned), self pairs included: r0 = 0, or
    r0 = V - 300, whose last 212 rows are pad rows."""
    counts = _row_counts(kind, 512, v, cuda)
    for r0 in (0, v - 300):
        before = ops.LAUNCHES["row_topk"]
        got = ops.row_top_k(counts, r0, k)
        assert ops.LAUNCHES["row_topk"] == before + 1
        want = ref.row_top_k_ref(counts, r0, k)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (r0, kind)


@pytest.mark.gpu
@pytest.mark.parametrize("r,v,k,offset", [
    (3, 50, 60, 0),          # k > V: the kernel takes 50, the wrapper pads
    (1, 5, 4, 1),            # one ragged row, inside one 16-byte word
    (7, 1000, 128, 3),       # rows of a wider buffer, off its alignment
    (130, 4099, 33, 2),
    (2, 40_000, 16, 0)])
def test_row_top_k_kernel_on_ragged_views(cuda, r, v, k, offset):
    """Views into a wider buffer (any row stride, any 4-byte offset) and
    k above V: the kernel reads its columns in place and equals the plain
    version."""
    buf = _row_counts("zipf", r, v + 5, cuda)
    counts = buf[:, offset:offset + v]
    for r0 in (0, max(v - r // 2, 0)):
        got = ops.row_top_k(counts, r0, k)
        want = ref.row_top_k_ref(counts, r0, k)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), r0


@pytest.mark.gpu
def test_staged_sweep_takes_the_row_top_k_and_never_waits(cuda,
                                                          monkeypatch):
    """A CSL-shaped staged sweep (65,536 terms): one row top-k launch a
    row group with documents, the network equal to "gemm"'s; once its
    plan is built, the sweep runs without a synchronising call (sync
    debug mode "error") and without torch.topk or torch.sort."""
    import importlib
    from repro_torch.core import materialize
    from repro_torch.core.network import CoocNetwork
    mat = importlib.import_module("repro_torch.core.materialize")
    n, v, k = 30_000, 65_536, 16
    docs = synthetic_csl(n, v, seed=12)
    ctx = QueryContext.from_docs(docs, v, device=cuda)
    step = mat.GROUP * 128
    held = np.zeros((n, v // step), dtype=bool)
    for i, d in enumerate(docs):
        held[i, np.asarray(d, dtype=np.int64) // step] = True
    groups = int((held.sum(0) > 0).sum())
    before = ops.LAUNCHES["row_topk"]
    net = materialize(ctx, k=k, method="pallas", use_cache=False)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["row_topk"] - before == groups
    want = materialize(ctx, k=k, method="gemm", use_cache=False)
    for a, b in zip(net, want):
        assert torch.equal(a, b)

    def refused(*a, **kw):
        raise AssertionError("torch.topk or torch.sort in the sweep")

    monkeypatch.setattr(torch, "topk", refused)
    monkeypatch.setattr(torch, "sort", refused)
    torch.cuda.set_sync_debug_mode("error")
    try:
        w, i = mat._compacted_sweep(ctx.index, ctx, None, k=k, bm=128)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    monkeypatch.undo()
    again = CoocNetwork(*mat._edge_slots(w[:v], i[:v].to(torch.int32)))
    for a, b in zip(again, net):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------


def _gpu_kernel_args(name, device):
    """Operands of one launch of kernel ``name`` on ``device``."""
    g = torch.Generator(device="cpu").manual_seed(0)
    if name in ("postings_counts", "level_step"):
        masks = torch.randint(-2 ** 31, 2 ** 31, (8, 40), generator=g,
                              dtype=torch.int32).to(device)
        packed = torch.randint(-2 ** 31, 2 ** 31, (40, 256), generator=g,
                               dtype=torch.int32).to(device)
        if name == "postings_counts":
            return (masks, packed), {}
        terms = torch.arange(8, dtype=torch.int32, device=device)
        valid = torch.ones(8, dtype=torch.bool, device=device)
        visited = torch.zeros(2, 256, dtype=torch.bool, device=device)
        return (masks, packed, terms, valid, visited), dict(v=256, k=16)
    if name == "cooccur_counts":
        x = torch.randint(0, 2, (128, 64), generator=g,
                          dtype=torch.int8).to(device)
        xt = x.t().contiguous().t()            # doc axis contiguous
        return (xt, xt), {}
    if name == "dot_interaction":
        return (torch.randn(64, 27, 64, generator=g).to(device),), {}
    if name == "row_topk":
        counts = torch.randint(0, 9, (8, 300), generator=g,
                               dtype=torch.int32).to(device)
        return (counts, 5, 16), {}
    q = torch.randn(2, 8, 64, generator=g).to(device)
    k = torch.randn(2, 256, 2, 64, generator=g).to(device)
    return (q, k, k.clone()), {}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["postings_counts", "level_step",
                                  "cooccur_counts", "dot_interaction",
                                  "flash_decode", "row_topk"])
def test_kernel_launches_charge_their_meta_counts(cuda, name):
    """A launch on the card charges a Counter exactly what its ``meta``
    stand-in charges: the launch layer's FLOP gate rests on it."""
    from repro_torch.launch.roofline import Counter
    call = getattr(ops, {"row_topk": "row_top_k"}.get(name, name))
    got = {}
    for dev in (cuda, torch.device("meta")):
        args, kw = _gpu_kernel_args(name, dev)
        if name == "flash_decode":
            kw = dict(length=torch.full((2,), 200, device=dev))
        with Counter() as c:
            call(*args, **kw)
        got[dev.type] = c.kernels[name], c.kernel_ops
    assert got["cuda"] == got["meta"]
    assert got["cuda"][0]["launches"] == 1 and got["cuda"][1] > 0


@pytest.fixture
def small_cells(monkeypatch):
    """dlrm-rm2 at 1,000 rows a field and the CSL index at 256 terms and
    1,500 docs, for the dry-run's card path."""
    import importlib
    from repro_torch.configs import _ARCH_MODULES, replace
    for arch, kw in [("dlrm-rm2", dict(vocab_per_field=1000)),
                     ("cooccur-csl", dict(vocab_size=256, n_docs=1500))]:
        m = importlib.import_module(_ARCH_MODULES[arch])
        monkeypatch.setattr(m, "CONFIG", replace(m.CONFIG, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("arch,shape,method", [
    ("dlrm-rm2", "serve_p99", None), ("dlrm-rm2", "train_batch", None),
    ("gin-tu", "molecule", None), ("cooccur-csl", "query_bfs_d3", "gemm"),
    ("cooccur-csl", "query_bfs_d3", "fused"),
    ("cooccur-csl", "query_batch", "pallas"),
    ("cooccur-csl", "build_full", None)])
def test_dryrun_host_cell_counts_what_meta_counts(cuda, small_cells,
                                                  monkeypatch, arch, shape,
                                                  method):
    """``dryrun.host_cell`` on the card: the counted FLOPs equal the
    ``meta`` plan's, the outputs are finite, a step is timed and the peak
    read from the allocator."""
    from repro_torch.launch import dryrun as DR
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if method:
        monkeypatch.setenv("REPRO_COOC_METHOD", method)
    meta, = DR.plan_records(arch, shape, (), None, "scan", verbose=False)
    rec, _ = DR.host_cell(arch, shape, meta, device=cuda, mode="scan",
                          verbose=False)
    assert rec["status"] == "ok" and rec["mesh"].startswith("host-")
    assert rec["counts"]["flops"] == meta["counts"]["flops"]
    assert rec["counts"]["kernels"] == meta["counts"]["kernels"]
    assert rec["counts"]["flops"] + rec["counts"]["kernel_ops"] > 0
    assert rec["t_step_s"] > 0
    assert rec["memory"]["peak_per_device_bytes"] > 0


@pytest.mark.gpu
def test_restore_shards_onto_the_card(cuda, tmp_path):
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import checkpoint
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.arange(8, dtype=torch.bfloat16)}
    checkpoint.save(str(tmp_path), 1, tree)
    mesh = make_mesh((2, 1), ("data", "model"), [cuda] * 2)
    sh = {k: S.NamedSharding(mesh, S.P("data")) for k in tree}
    got, _ = checkpoint.restore(str(tmp_path), tree, shardings=sh)
    for k, v in got.items():
        assert isinstance(v, S.ShardedTensor)
        assert all(s.is_cuda for s in v.shards.values())
        assert torch.equal(v.gather("cpu"), tree[k])


# -- ids out of range on the card ---------------------------------------------


def _slots_np(net):
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else a
    return np.stack([np.asarray(host(getattr(net, f))).astype(np.int64)
                     for f in ("src", "dst", "weight", "valid")])


@pytest.mark.gpu
@pytest.mark.parametrize("mesh", [None, "terms"])
def test_card_answers_a_bad_seed_and_a_later_query(cuda, mesh):
    """Seeds V and V + 3 beside good ones through the engine on the card,
    under all four methods (on a term mesh of 3 shards of the card too):
    no device-side assert, every answer equal to the CPU's, and a later
    query in the same process equal too."""
    from repro_torch.core import make_cooc_mesh
    from repro_torch.serve import CoocEngine
    v = 29
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, v, rng.integers(1, 8)).tolist()
            for _ in range(200)]
    kw = {} if mesh is None else dict(mesh=make_cooc_mesh(
        devices=[cuda] * 3, shard=mesh))
    card = QueryContext.from_docs(docs, v, device=cuda, **kw)
    host = QueryContext.from_docs(docs, v, device="cpu")
    specs = [(1,), (v,), (v + 3,), (4, v), (2,)]
    for method in ("gemm", "popcount", "pallas", "fused"):
        plan = dict(depth=2, topk=4, beam=4, method=method)
        eng = CoocEngine(card, device=cuda, q_batch=8, **plan)
        want = [construct(host, QuerySpec(seeds=s, **plan)) for s in specs]
        futs = [eng.submit(s) for s in specs]
        got = [f.result() for f in futs]
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_slots_np(g.network),
                                          _slots_np(w.network))
        later = eng.submit((3,)).result()
        torch.cuda.synchronize()
        np.testing.assert_array_equal(
            _slots_np(later.network),
            _slots_np(construct(host, QuerySpec(seeds=(3,), **plan)).network))
        eng.shutdown()


@pytest.mark.gpu
def test_card_answers_a_bad_token_and_a_later_decode(cuda):
    """llama at 2 layers of d 128, fp32: a prompt with a token past the
    vocab among good ones gives the CPU's streams (its own all 0, the
    others as without it), and a later decode equals the CPU's."""
    from repro_torch.configs import get_config, replace
    from repro_torch.models import transformer as T
    from repro_torch.serve import DecodeServer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(get_config("llama3-8b"), n_layers=2, d_model=128,
                  n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
                  vocab_size=500, attn_q_chunk=0)
    host = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                         dtype=torch.float32)
    card = T.LM(cfg, device=cuda, dtype=torch.float32)
    card.load_state_dict(host.state_dict())
    prompts = [[4, 5, 6], [1, 2, cfg.padded_vocab + 7, 3], [9, 8], [3, 3, 3]]
    streams = []
    for model, dev in ((card, cuda), (host, "cpu")):
        out = []
        for ps in (prompts, prompts[:1] + prompts[2:]):
            srv = DecodeServer(cfg, model, slots=2, max_len=16, device=dev)
            for p in ps:
                srv.submit(p, max_new_tokens=4)
            out.append({r.rid: r.out_tokens
                        for r in srv.run_until_drained()})
            if dev != "cpu":
                torch.cuda.synchronize()
        streams.append(out)
    assert streams[0] == streams[1]
    with_bad, without = streams[0]
    assert with_bad[1] == [0, 0, 0, 0]
    assert [with_bad[i] for i in (0, 2, 3)] == [without[i] for i in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dlrm-rm2", "deepfm", "sasrec"])
def test_card_answers_a_bad_sparse_id_and_a_later_serve(cuda, arch):
    """An id past the table (and one that wraps) in one sample each:
    ``serve_fn`` on the card has NaN exactly where the CPU's has it and
    equals it elsewhere (DLRM through kernel 4), and a later clean
    ``serve_fn`` equals the CPU's."""
    from repro_torch.configs import get_config, replace
    from repro_torch.data import recsys_batch
    from repro_torch.models import recsys as R
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = replace(get_config(arch), vocab_per_field=1000, n_items=1000,
                  seq_len=min(get_config(arch).seq_len, 16))
    host = R.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = type(host)(cfg, device=cuda)
    card.load_state_dict(host.state_dict())
    b = recsys_batch(cfg, 64, 1)
    if arch == "sasrec":
        b = {"seq": b["seq"], "candidates": np.random.default_rng(0).integers(
            0, 1000, (64, 20)).astype(np.int32)}
        bad = {k: v.copy() for k, v in b.items()}
        bad["seq"][3, 2], bad["candidates"][5, 1] = 10 ** 6, -1
    else:
        b = {k: b[k] for k in ("dense", "sparse_ids") if k in b}
        bad = {k: v.copy() for k, v in b.items()}
        bad["sparse_ids"][3, 2], bad["sparse_ids"][5, 0] = 10 ** 6, -1
    for batch in (bad, b):
        got = R.serve_fn(cfg, card, R.as_batch(batch, cuda))
        torch.cuda.synchronize()
        want = R.serve_fn(cfg, host, R.as_batch(batch, "cpu"))
        g, w = got.cpu().numpy(), want.numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    assert np.isnan(R.serve_fn(cfg, card, R.as_batch(bad, cuda)).cpu()
                    .numpy()).any()


@pytest.mark.gpu
def test_card_ops_carry_nan_as_the_plain_versions_do(cuda):
    """Kernel 4 on an input with a NaN row, ``scatter_reduce("amax")``
    (the ragged ``"max"`` bag), ``argmax`` over NaN and GIN over a bad
    edge: NaN where the CPU puts it."""
    from repro_torch.configs import get_config
    from repro_torch.data import gnn_synthetic_graph
    from repro_torch.models import gnn as G
    from repro_torch.models import recsys as R
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((256, 27, 64)).astype(
        np.float32))
    x[7, 3] = float("nan")
    got = ops.dot_interaction(x.to(cuda))
    torch.cuda.synchronize()
    want = ref.dot_interaction_ref(x)
    np.testing.assert_array_equal(torch.isnan(got).cpu().numpy(),
                                  torch.isnan(want).numpy())
    assert torch.isnan(want[7]).any() and not torch.isnan(want[8]).any()
    table = torch.from_numpy(rng.standard_normal((50, 6)).astype(np.float32))
    flat = torch.tensor([0, 1, 70, 7, 3, -2, 12, 41, 2])
    seg = torch.tensor([0, 0, 1, 1, 1, 3, 3, 9, 4])
    for comb in ("sum", "mean", "max"):
        g = R.embedding_bag_ragged(table.to(cuda), flat.to(cuda),
                                   seg.to(cuda), 5, combiner=comb).cpu()
        w = R.embedding_bag_ragged(table, flat, seg, 5, combiner=comb)
        torch.testing.assert_close(g, w, equal_nan=True)
    logits = torch.tensor([[1.0, float("nan"), 3.0], [float("nan")] * 3])
    assert logits.to(cuda).argmax(-1).cpu().tolist() == \
        logits.argmax(-1).tolist() == [1, 0]
    cfg = get_config("gin-tu")
    gr = gnn_synthetic_graph(128, 512, 32, 8, seed=0)
    gr["edge_src"][5], gr["edge_dst"][9] = 128, 128 + 3
    host = G.init_gin(cfg, torch.Generator().manual_seed(0), 32, 8,
                      device="cpu")
    card = G.GIN(cfg, 32, 8, device=cuda)
    card.load_state_dict(host.state_dict())
    hb = {k: torch.from_numpy(v) for k, v in gr.items()}
    g = G.gin_forward(cfg, card, *(hb[k].to(cuda) for k in
                                   ("x", "edge_src", "edge_dst"))).cpu()
    torch.cuda.synchronize()
    w = G.gin_forward(cfg, host, hb["x"], hb["edge_src"], hb["edge_dst"])
    torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, equal_nan=True)
    assert torch.isnan(w).any() and not torch.isnan(w).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_take_gradient_on_the_card_is_the_same_in_every_run(cuda, dtype):
    """2^20 ids over 1,000 rows, two past the table: ``take``'s gradient
    into the table on the card is the same bit for bit in three runs
    (the gradients that ``cfg.remat``'s gate compares), and in fp32 equal
    to the CPU's."""
    from repro_torch.models import layers as L
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((1000, 64)).astype(
        np.float32)).to(dt)
    ids = rng.integers(0, 1000, 1 << 20).astype(np.int32)
    ids[[5, 9]] = 1000, -1001
    ids = torch.from_numpy(ids)
    w = torch.from_numpy(rng.standard_normal((1 << 20, 64)).astype(
        np.float32)).to(dt)

    def grad(dev):
        t = table.to(dev).requires_grad_()
        (L.take(t, ids.to(dev)).nan_to_num(0.0) * w.to(dev)).sum().backward()
        return t.grad.float().cpu().numpy()
    runs = [grad(cuda) for _ in range(3)]
    for g in runs[1:]:
        np.testing.assert_array_equal(g, runs[0])
    if dtype == "float32":
        np.testing.assert_allclose(runs[0], grad("cpu"), rtol=1e-4,
                                   atol=1e-3)
