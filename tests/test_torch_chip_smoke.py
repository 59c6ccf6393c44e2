"""A CPU rehearsal of ``chip_smoke.py``'s phases at a tiny size.

The script needs a CUDA card to run for real.  Here the card's timing and
memory calls are stubbed, the kernel wrappers are told that every tensor is
on the card, and the CUDA launchers are replaced by the kernels' plain
versions, so every phase runs its own control flow, its launch counting,
its oracle checks and its kernels line end to end.  What this cannot show
— that the CUDA sources build and agree with the plain versions — only a
run on the card shows.
"""
import sys
import time
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
# kernel 4's entry also separates device time from host time, its own and
# torch.bmm's
DOT_KEYS = KEYS | {"device_ms", "host_us", "bmm_device_ms", "bmm_host_us"}


class _Event:
    def __init__(self, enable_timing=False):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("chip_smoke", None)
    import chip_smoke
    from repro_torch.kernels import (cooccur, dot_interaction, flash_decode,
                                     level_step, ops, postings, ref,
                                     row_topk)
    for name, value in [
            ("Event", _Event), ("synchronize", lambda *a: None),
            ("reset_peak_memory_stats", lambda *a: None),
            ("max_memory_allocated", lambda *a: 0),
            ("memory_allocated", lambda *a: 0),
            ("empty_cache", lambda: None),
            ("get_device_properties",
             lambda i: types.SimpleNamespace(multi_processor_count=132))]:
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(torch, "_int_mm", lambda a, b: (
        a.to(torch.int32) @ b.to(torch.int32)))
    monkeypatch.setattr(chip_smoke, "smi", lambda q: "1980 MHz"
                        if q.startswith("clocks") else "stub card, 700 W")
    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(postings, "postings_counts_cuda",
                        ref.postings_counts_ref)
    # the compaction launch: its plain lists (nothing reads the staged words)
    monkeypatch.setattr(postings, "active_words_cuda",
                        lambda m: (*ref.active_words_ref(m, postings.ROWS),
                                   None))
    monkeypatch.setattr(level_step, "level_step_cuda", ref.level_step_ref)
    # the launcher takes (M, K) and (N, K), the operands' .t() views, and
    # reports the path the kernel's own test picks: TMA where both bases
    # and row strides are multiples of 16 bytes
    def cooccur_stub(a, b):
        tma = all(x.data_ptr() % 16 == 0 and x.stride(0) % 16 == 0
                  for x in (a, b))
        return (ref.cooccur_counts_ref(a.t(), b.t()),
                "tma" if tma else "bytes")

    monkeypatch.setattr(cooccur, "cooccur_counts_cuda", cooccur_stub)
    monkeypatch.setattr(dot_interaction, "dot_interaction_cuda",
                        ref.dot_interaction_ref)
    monkeypatch.setattr(flash_decode, "flash_decode_cuda",
                        lambda q, k, v, ln, chunk: ref.flash_decode_ref(
                            q, k, v, ln, chunk=chunk))
    monkeypatch.setattr(row_topk, "row_top_k_cuda", ref.row_top_k_ref)
    for name, value in [("CSL_DOCS", 1500), ("CSL_TERMS", 256),
                        ("MID_DOCS", 1024), ("MID_TERMS", 128),
                        ("MESH_TERMS", 250),
                        ("N_QUERIES", 16), ("DLRM_VOCAB", 1000),
                        ("SHA_PROBE_BYTES", 1 << 20),
                        ("SERVE_P99", 16), ("SERVE_BULK", 96),
                        ("RETRIEVAL_CAND", 300), ("N_P99_BATCHES", 5),
                        ("DECODE_HEADS", (8, 2, 16)),
                        ("DECODE_SHAPES", {"decode_32k": (3, 100),
                                           "long_500k": (1, 300)})]:
        monkeypatch.setattr(chip_smoke, name, value)
    # the phases run plain PyTorch on tiny tensors: one intra-op thread,
    # so that a pool of a thread per core does not stall beside the other
    # test workers (on 8 cores beside six busy processes, the phases test
    # took 180 s with 8 threads and 12 s with one)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield chip_smoke
    torch.set_num_threads(threads)


def test_chip_smoke_phases_rehearse_on_the_cpu(smoke, capsys):
    dev = torch.device("cpu")
    smoke.phase_strings(dev)
    ctx, hidx, seeds, launches = smoke.phase_csl(dev)
    assert launches == {"level_step": 6, "postings_counts": 6}
    exact, exact_s = smoke.phase_materialize(dev, ctx, hidx, launches)
    # 256 terms: one launch of GROUP = 4 row blocks of 128 (two of them
    # past V), on the TMA path
    assert launches["cooccur_counts"] == 1
    assert ctx.unpack_count == 1
    assert exact.max_edges == 256 * 16 and exact_s > 0
    approx = smoke.phase_approx(dev, ctx, hidx, exact, exact_s)
    assert ctx.unpack_count == 1        # "gemm" approx reuses x_dense
    kernels = smoke.phase_kernels(dev, ctx, seeds, launches)
    mesh = smoke.phase_mesh(dev, ctx, seeds, exact, exact_s, *approx)
    # 2 batches x depth 3 x 4 shards: term mesh "fused" (kernel 2) and
    # "pallas" (kernel 1), doc mesh both (kernel 1); 256 terms: "rows"
    # one launch on each of the two shards that hold row blocks, "cols"
    # and the doc split one group on each of 4 shards
    assert mesh["level_step"] == 24
    assert mesh["cooccur_counts"] == 2 + 4 + 4
    assert mesh["postings_counts"] >= 3 * 24
    assert [k["name"] for k in kernels] == ["postings_counts", "level_step",
                                            "cooccur_counts", "row_topk"]
    assert [k["launches"] for k in kernels] == [6, 6, 1, 1]
    for k in kernels:
        assert set(k) == KEYS
        assert k["max_abs_err"] == 0
        assert (ROOT / k["source"]).is_file()
        assert k["bound_ms"] > 0 and k["bound_by"] in ("bytes", "operations")
    assert kernels[2]["bound_by"] == kernels[3]["bound_by"] == "bytes"
    assert ctx.unpack_count == 1        # the yardsticks reuse x_dense
    out = capsys.readouterr().out
    assert "[csl] method=fused" in out and "[csl] method=pallas" in out
    assert "[materialize] method=pallas" in out
    assert "[materialize] method=gemm" in out
    assert "[materialize] identical=True rows_checked=16" in out
    # the quickstart snapshot, and the approximate CSL sweep both ways
    assert "[strings] snapshot_blobs=" in out
    assert "loaded_equal=True approx_equal_cpu=True" in out
    assert ("[strings] mesh_shards=4 mesh_kinds=terms,docs mesh_oracle=True "
            "mesh_loaded_equal=True mesh_served_equal=16 "
            "one_shard_mesh=True") in out
    for kind in ("terms", "docs"):
        for method in ("fused", "pallas"):
            assert (f"[mesh] mesh={kind} shards=4 method={method} "
                    "queries=16 batches=2 ") in out
            assert "launches_per_batch_per_shard=3.00 " in out
    assert "[mesh] mesh=terms shards=4 strategy=rows " in out
    assert "[mesh] mesh=terms shards=4 strategy=cols " in out
    assert "[mesh] mesh=docs shards=4 strategy=cols " in out
    assert "[mesh] mesh=terms shards=4 mode=approx " in out
    assert "signatures_identical=True" in out
    for what in ("none", "terms", "docs"):
        for method in ("fused", "pallas"):
            assert (f"[mesh] profile={what}_{method}_batch "
                    "device_busy_ms=not-measured") in out
    assert "[approx] method=pallas k=16 " in out
    assert "[approx] method=gemm k=16 " in out
    assert "[approx] identical=True sig_s=" in out
    assert "[approx] kernel=postings_counts row_block=" in out
    assert "signatures_checked=" in out
    assert "kernel=postings_counts frontier=level-1 tile_rows=4 " in out
    assert "compaction_ms=" in out
    for level in (0, 2):
        assert f"kernel=postings_counts frontier=level-{level}" in out
    for level in (0, 1, 2):
        assert f"kernel=level_step frontier=level-{level}" in out
    for g in (1, 2, 4, 8):
        assert f"kernel=cooccur_counts row_blocks={g} " in out
    assert 'group=4 ' in out and '"tma": 1' in out


def test_chip_smoke_stream_phase_rehearses_on_the_cpu(smoke, monkeypatch,
                                                     capsys):
    """A window of 300 docs (capacity 320), filled in blocks of 64, then
    3 evicting rounds: the first writes slots 300..319 and wraps to 0.
    Then the snapshot phase saves that ring and the serve phase's warm
    start restores it, and the server replays a short trace on it.  The
    trace keeps the card run's burst, queue bound and hostile plans; its
    deadlines and wait budget are a minute here, since a CPU shared with
    other test workers times nothing the gate could hold."""
    for name, value in [("STREAM_WINDOW", 300), ("STREAM_BLOCK", 64),
                        ("STREAM_ROUNDS", 3), ("SERVE_STEADY", 120),
                        ("SERVE_CAPACITY_BATCHES", 2),
                        ("SERVE_DEADLINE_MS", 60_000.0),
                        ("SERVE_WAIT_MS", 60_000.0)]:
        monkeypatch.setattr(smoke, name, value)
    launches, state = smoke.phase_stream(torch.device("cpu"))
    # 3 post-ingest batches and the oracle batch at depth 2 through kernel
    # 2, the oracle batch through kernel 1, one all-time sweep of 256 terms
    assert launches == {"postings_counts": 2, "level_step": 8,
                        "cooccur_counts": 1}
    assert state["ctx"].scope_names() == ("rounds",)
    serve = smoke.phase_snapshot(torch.device("cpu"), state)
    assert state == {}
    assert set(serve) == {"server", "gamma_docs"}
    assert serve["server"].ctx.scope_names() == ("rounds",)
    assert sorted(serve["server"].tenants) == ["alpha", "beta", "gamma"]
    smoke.phase_serve(torch.device("cpu"), serve)
    assert serve == {}
    out = capsys.readouterr().out
    assert "[stream] window=300 capacity=320 words=10 " in out
    assert "fill_ingests=5 " in out
    assert "[stream] round=0 slots=300..43 " in out
    assert "[stream] round=2 slots=108..171 " in out
    assert "evicted=192 cold_blocks=3 " in out
    assert "payload_mb=0.002 encode_ms=" in out      # 2 words x 256 terms
    assert "doc_freq_exact=True oracle_queries=8" in out
    # 10 live words and 3 blocks of 2 words stacked
    assert "all_time_words=16 all_time_slots=512 " in out
    assert "gemm_oracle=True" in out
    assert "[stream] fresh_docs=492 identical=True rows_checked=16" in out
    # the ring after the rounds: 300 live docs in 5 blocks, 3 cold blocks
    assert "[snapshot] live_blocks=5 cold_blocks=3 scopes=rounds " in out
    assert "[snapshot] restored_equal=True rehashed_blocks=0 " in out
    assert "fsync_s=" in out and "host_sha256_gb_per_s=" in out
    assert "next_ingest_identical=True" in out
    # the warm start, before the snapshot phase's checks ran on it
    assert out.index("[serve] warm_start_s=") < out.index(
        "[snapshot] restored_equal=True")
    assert ("live_blocks=5 cold_blocks=3 scopes=rounds state_equal=True "
            "tenants=alpha,beta,gamma") in out
    assert "[serve] capacity_qps=" in out and "cold_first_step_ms=" in out
    assert 'checked_before=[64, 8]' in out and 'checked_after=[64, 8]' in out
    # 120 steady + 256 burst + 6 hostile requests
    assert "[serve] offered=382 " in out
    assert '"burst:shed:queue_full": ' in out
    assert "errors=0 " in out and "misses=0 " in out
    assert "[serve] ingests=4 " in out
    assert "profile=fused_batch device_busy_ms=not-measured" in out
    assert "[serve] acceptance=True " in out


def test_chip_smoke_dlrm_and_decode_phases_rehearse_on_the_cpu(smoke,
                                                               capsys):
    dev = torch.device("cpu")
    launches = {}
    cfg, model, batches = smoke.phase_dlrm(dev, launches)
    assert launches == {"dot_interaction": 5 + 3 + 1}   # p99, bulk, retrieval
    assert model.table.shape == (26 * 1000, 64)
    k4 = smoke.phase_kernel_dot(dev, cfg, model, batches, launches)
    smoke.phase_decode(dev, launches)
    assert launches["flash_decode"] == 3
    k5 = smoke.phase_kernel_decode(dev, launches)
    assert [k4["name"], k5["name"]] == ["dot_interaction", "flash_decode"]
    assert [k4["launches"], k5["launches"]] == [9, 3]
    assert set(k4) == DOT_KEYS and set(k5) == KEYS
    # no card: the profiler's device times are not measured, the host
    # clock is
    assert k4["device_ms"] is None and k4["bmm_device_ms"] is None
    assert k4["host_us"] > 0 and k4["bmm_host_us"] > 0
    for k in (k4, k5):
        assert (ROOT / k["source"]).is_file()
        assert k["bound_ms"] > 0 and k["bound_by"] == "bytes"
        assert k["max_abs_err"] == 0            # plain against plain here
        assert k["library_ms"] is not None
    out = capsys.readouterr().out
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        assert f"[dlrm] shape={shape}" in out
        assert f"kernel=dot_interaction shape={shape}" in out
    assert out.count("device_ms=not-measured host_us=") == 3
    assert out.count("bmm_device_ms=not-measured bmm_host_us=") == 3
    assert "tf32=False matmul_precision=highest" in out
    for shape in ("decode_32k", "long_500k"):
        assert f"[decode] shape={shape}" in out
        assert f"kernel=flash_decode shape={shape}" in out
    assert "lengths=0.." in out
    assert "sdpa_gqa_copies_cache=" in out


def test_chip_smoke_decode_check_fails_a_wrong_kernel(smoke):
    """The bf16 check of kernel 5 at a long, flat softmax (|out| about
    sqrt(e / S)) passes the same attention summed in float64 and rounded
    once, and fails a kernel of zeros and one that drops an eighth of S."""
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(0)
    b, hq, hkv, d, s = 3, 8, 2, 128, 8192
    q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16)
               for shape in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    ln = torch.full((b,), s, dtype=torch.int32)
    want = ref.flash_decode_ref(q, k, v, ln)
    qd = q.double().reshape(b, hkv, hq // hkv, d)
    p = torch.softmax(torch.einsum("bhgd,bshd->bhgs", qd, k.double())
                      / d ** 0.5, dim=-1)
    f64 = torch.einsum("bhgs,bshd->bhgd", p, v.double()).reshape(b, hq, d)
    assert smoke._check_decode(f64.to(torch.bfloat16), want, torch.bfloat16,
                               "f64") > 0
    for wrong in (torch.zeros_like(want),
                  ref.flash_decode_ref(q, k, v, ln - s // 8)):
        with pytest.raises(AssertionError, match="kernel != plain"):
            smoke._check_decode(wrong, want, torch.bfloat16, "wrong")


def test_chip_smoke_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("chip_smoke", None)
    import chip_smoke
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


# ---------------------------------------------------------------------------
# phase 13: the LM serving path
# ---------------------------------------------------------------------------

LM_SMALL = dict(n_layers=2, d_model=128, n_heads=4, d_ff=256, vocab_size=512,
                attn_q_chunk=0, head_dim=32)


@pytest.fixture
def lm_small(smoke, monkeypatch):
    """Phase lm at the reference's reduced widths (2 layers of d 128 for
    llama; 3 for deepseek: one dense, two MoE of 8 experts top-2, MLA
    rank 32), 2 slots of a 64-position cache, prompts of 4-12 tokens."""
    monkeypatch.setattr(smoke, "LM_CONFIG_OVERRIDES", {
        "llama3-8b": dict(LM_SMALL, n_kv_heads=2),
        "deepseek-v2-lite-16b": dict(
            LM_SMALL, n_layers=3, n_kv_heads=4, n_experts=8, top_k=2,
            d_ff_expert=64, n_shared_experts=1, kv_lora_rank=32,
            qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)})
    for name, value in [("LM_SERVED", {"llama3-8b": (5, 6),
                                       "deepseek-v2-lite-16b": (3, 4)}),
                        ("LM_SLOTS", 2), ("LM_MAX_LEN", 64),
                        ("LM_PROMPT_LENS", (4, 12)), ("LM_CPU_NEW", 3)]:
        monkeypatch.setattr(smoke, name, value)
    return smoke


def test_chip_smoke_lm_phase_rehearses_on_the_cpu(lm_small, capsys):
    from repro_torch.kernels import ops
    ops.reset_launches()
    lm_small.phase_lm(torch.device("cpu"))
    assert all(n == 0 for n in ops.LAUNCHES.values())
    out = capsys.readouterr().out
    assert "[lm] arch=llama3-8b layers=2 d_model=128 experts=dense " \
           "attention=gqa " in out
    assert "[lm] arch=deepseek-v2-lite-16b layers=3 d_model=128 " \
           "experts=8x2+1 attention=mla " in out
    assert "[lm] arch=llama3-8b requests=5 new_tokens=6 slots=2 " in out
    assert "[lm] arch=deepseek-v2-lite-16b requests=3 new_tokens=4 " in out
    # two requests checked, every decode step of each
    assert "decode_vs_prefill_requests=2 steps=10 " in out
    assert "decode_vs_prefill_requests=2 steps=6 " in out
    assert "routed_experts_per_layer=" in out and "bytes_bound_ms=" in out
    assert "profile=llama3-8b decode_step device_busy_ms=not-measured" in out
    for arch in ("llama3-8b", "deepseek-v2-lite-16b"):
        assert (f"[lm] arch={arch} card_vs_cpu_layers=2 dtype=float32 "
                "requests=2 tokens_identical=True steps=4 ") in out
    assert "[lm] kernel_launches_moved=False " in out


def _interleaved_rope(x, positions, theta):
    """RoPE over interleaved pairs, not the reference's halves."""
    from repro_torch.models import layers
    angles = positions[..., None].float() * layers.rope_freqs(
        x.shape[-1], theta, x.device)
    if x.dim() == angles.dim() + 1:
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float()[..., 0::2], x.float()[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).flatten(-2).to(x.dtype)


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-lite-16b"])
def test_chip_smoke_decode_check_fails_a_wrong_model(lm_small, monkeypatch,
                                                     arch):
    """A model whose decode rotates interleaved pairs (its prefill keeps
    the halves) serves whole streams, but the decode-against-prefill
    check refuses it."""
    from repro_torch.models import layers, transformer as T
    real = T._decode_attn

    def wrong_decode_attn(*args):
        T.apply_rope = _interleaved_rope
        try:
            return real(*args)
        finally:
            T.apply_rope = layers.apply_rope

    lm_small._lm_serve(torch.device("cpu"), arch, 3, 5)       # passes
    monkeypatch.setattr(T, "_decode_attn", wrong_decode_attn)
    with pytest.raises(AssertionError, match="decode != prefill"):
        lm_small._lm_serve(torch.device("cpu"), arch, 3, 5)


def test_chip_smoke_lm_only_runs_the_device_and_lm_phases(smoke, monkeypatch,
                                                          capsys):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(smoke, "phase_device",
                        lambda: calls.append("device") or "stub card, 700 W")
    monkeypatch.setattr(smoke, "phase_lm", lambda dev: calls.append("lm"))
    monkeypatch.setattr(smoke, "phase_strings", lambda dev: calls.append(
        "strings"))
    assert smoke.main(["--lm-only"]) == 0
    assert calls == ["device", "lm"]
    out = capsys.readouterr().out
    assert '"ok"' not in out and "stub card, 700 W" in out


# ---------------------------------------------------------------------------
# phase 14: the side models
# ---------------------------------------------------------------------------


@pytest.fixture
def side_small(smoke, monkeypatch):
    """Phase side at reduced sizes with the published widths: 1,000 rows a
    field or items, bert4rec's sequences of 16 served in slices of 40
    (serve_bulk 96 rows: 40, 40, 16), ogb_products and minibatch_lg on
    small synthetic graphs (16 seeds, fanouts 15 and 10), molecule and
    full_graph_sm as published; two timed calls a cell."""
    monkeypatch.setattr(smoke, "SIDE_CONFIG_OVERRIDES", {
        "deepfm": dict(vocab_per_field=1000),
        "sasrec": dict(n_items=1000),
        "bert4rec": dict(n_items=1000, seq_len=16)})
    monkeypatch.setattr(smoke, "GNN_CELL_OVERRIDES", {
        "ogb_products": dict(n_nodes=3000, n_edges=20000),
        "minibatch_lg": dict(n_nodes=2000, n_edges=30000, batch_nodes=16)})
    for name, value in [("SIDE_P99_BATCHES", 3),
                        ("SIDE_BULK_SLICE", {"bert4rec": 40}),
                        ("GNN_CALLS", dict.fromkeys(
                            ("ogb_products", "minibatch_lg", "molecule",
                             "full_graph_sm"), 2))]:
        monkeypatch.setattr(smoke, name, value)
    return smoke


def test_chip_smoke_side_phase_rehearses_on_the_cpu(side_small, capsys):
    from repro_torch.kernels import ops
    ops.reset_launches()
    side_small.phase_side(torch.device("cpu"))
    assert all(n == 0 for n in ops.LAUNCHES.values())
    out = capsys.readouterr().out
    assert "[side] arch=deepfm interaction=fm table_rows=39000 embed=10 " \
           "mlp=400-400-400 " in out
    assert "[side] arch=bert4rec interaction=bidir-seq table_rows=1002 " \
           "embed=64 seq_len=16 blocks=2 heads=2 " in out
    for arch in ("deepfm", "sasrec", "bert4rec"):
        for cell in ("serve_p99", "serve_bulk", "retrieval_cand"):
            assert f"[side] arch={arch} cell={cell} " in out
            assert f"[side] cell={arch} {cell} bytes=" in out
        assert f"profile={arch} serve_p99 device_busy_ms=not-measured" in out
    assert "arch=bert4rec cell=serve_bulk batch=96 rows_a_call=40 " in out
    assert "arch=sasrec cell=serve_bulk batch=96 rows_a_call=96 " in out
    for cell in ("ogb_products", "minibatch_lg", "molecule", "full_graph_sm"):
        assert f"[side] arch=gin-tu cell={cell} " in out
        assert f"[side] cell=gin-tu {cell} message_bytes=" in out
    # the sampled subgraph keeps its fixed shape: (N_max, E_max)
    assert "cell=minibatch_lg nodes=2656 edges=2640 d_feat=602 " in out
    assert "cell=molecule nodes=3840 edges=8192 d_feat=16 classes=2 " \
           "loss_fn=graph_loss " in out
    assert "agg_nodes=64 " in out and "bits_identical_across_runs=True" in out
    assert out.count(" max_abs_err_vs_f64=") == 9 + 2     # and the aggregate
    assert '[side] card_vs_cpu={"deepfm": ' in out
    assert "[side] graphs_built_side_by_side=ogb_products,minibatch_lg " in out
    assert "[side] kernel_launches_moved=False " in out


def _unbiased_layer_norm(x, g):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True)                    # correction=1
    return ((xf - mu) * torch.rsqrt(var + 1e-5) * g).to(x.dtype)


def test_chip_smoke_side_gate_fails_an_unbiased_layer_norm(side_small,
                                                           monkeypatch):
    """GIN with ``torch.var``'s default (unbiased) variance serves every
    cell and passes the aggregate check, but its logits miss the float64
    forward."""
    from repro_torch.models import gnn as G
    monkeypatch.setattr(G, "_layer_norm", _unbiased_layer_norm)
    with pytest.raises(AssertionError, match="logits != float64"):
        side_small._side_gnn(torch.device("cpu"))


def test_chip_smoke_side_gate_fails_a_wrong_fm_term(side_small, monkeypatch):
    """DeepFM without the FM second order's halving misses float64."""
    from repro_torch.models import recsys as R
    real = R.deepfm_logits

    def doubled(cfg, model, batch):
        rows = R._flat_field_ids(cfg, batch["sparse_ids"])
        emb = model.table[rows]
        s = emb.sum(1)
        extra = 0.5 * (s * s - (emb * emb).sum(1)).sum(-1)
        return real(cfg, model, batch) + extra

    monkeypatch.setattr(R, "deepfm_logits", doubled)
    with pytest.raises(AssertionError, match="deepfm serve_p99: 64 sampled "
                                             "rows|deepfm serve_p99: 16"):
        side_small._side_recsys(torch.device("cpu"), "deepfm")


def test_chip_smoke_side_only_runs_the_device_and_side_phases(
        smoke, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(smoke, "phase_device",
                        lambda: calls.append("device") or "stub card, 700 W")
    for name in ("phase_side", "phase_lm", "phase_strings"):
        monkeypatch.setattr(smoke, name, lambda dev, n=name: calls.append(n))
    assert smoke.main(["--side-only"]) == 0
    assert calls == ["device", "phase_side"]
    out = capsys.readouterr().out
    assert '"ok"' not in out and "stub card, 700 W" in out


# ---------------------------------------------------------------------------
# phase 15: training
# ---------------------------------------------------------------------------


@pytest.fixture
def train_small(smoke, monkeypatch):
    """Phase train at reduced sizes: dlrm-rm2 with 1,000 rows a field and
    batches of 256 (3 steps, resumed to 6), llama3-8b at the reference's
    reduced widths (2 layers of d 128, sequences of 32), and three archs
    on the "card" (the CPU here) against the CPU."""
    from repro_torch.configs import get_config, replace
    from repro_torch.launch import train as TL

    def small(arch):
        cfg = get_config(arch)
        return replace(cfg, vocab_per_field=1000) if arch == "dlrm-rm2" \
            else cfg

    monkeypatch.setattr(TL, "get_config", small)
    monkeypatch.setattr(smoke, "LM_TRAIN_OVERRIDES", dict(
        LM_SMALL, n_kv_heads=2))
    for name, value in [("DLRM_TRAIN_BATCH", 256), ("DLRM_TRAIN_STEPS", 3),
                        ("DLRM_TIMED_STEPS", 3), ("DLRM_GATE_ROWS", 8),
                        ("DOT_GRAD_SAMPLES", 64), ("LM_TRAIN_BATCH", 2),
                        ("LM_TRAIN_SEQ", 32), ("LM_TRAIN_STEPS", 2),
                        ("TRAIN_ARCHS", ["dlrm-rm2", "gin-tu",
                                         "deepseek-v2-lite-16b"])]:
        monkeypatch.setattr(smoke, name, value)
    return smoke


def test_chip_smoke_train_phase_rehearses_on_the_cpu(train_small, capsys):
    """Every gate of phase train passes, and kernel 4 is counted once a
    forward pass: runs 1-3 (3, then 3 resumed, then 6), the gradient
    pair's kernel half, the warm-up, 3 timed steps, the AdamW gate, and
    the reduced dlrm-rm2 on both sides (3 + 3: the wrappers see a card
    here).  The profiled step runs only on a card."""
    out = train_small.phase_train(torch.device("cpu"))
    assert out["launches"] == 12 + 1 + 1 + 3 + 1 + 6
    assert out["backward"]["max_rel_err"] < 1e-5        # fp32 against f64
    text = capsys.readouterr().out
    assert "[train] arch=dlrm-rm2 runs=3,resume-to-6,6 batch=256 " in text
    assert "resume_equal=True " in text and "dot_launches=12 " in text
    assert "save_s=" in text and "restore_s=" in text
    assert "[train] kernel=dot_interaction_backward route=plain-pytorch " \
           "samples_checked=64 " in text
    assert "[train] arch=dlrm-rm2 cell=train batch=256 " in text
    assert "step_ms_p50=" in text and "bound_ms=" in text
    assert "profile=dlrm-rm2 step device_busy_ms=not-measured" in text
    assert "[train] adamw_vs_f64_rows=16 " in text
    assert "[train] arch=llama3-8b layers=2 d_model=128 " in text
    assert "remat=True remat_gate=True " in text
    assert '[train] card_vs_cpu={"dlrm-rm2": ' in text
    assert "[train] dot_interaction_launches=24 " in text


def _sparse_row_adamw(real_adamw):
    """AdamW that leaves the table rows the batch did not touch alone (a
    sparse-row update): not the reference's dense one."""
    from repro_torch import pytree
    from repro_torch.train import optimizer as TO

    def make(cfg):
        real = real_adamw(cfg)

        def update(grads, state, params):
            keep = []
            for p, g, m, v in zip(*(pytree.leaves(t) for t in (
                    params, grads, state["m"], state["v"]))):
                if p.dim() == 2 and p.shape[0] >= 1000:
                    idle = (g == 0).all(dim=1)
                    keep.append((p, m, v, idle, p[idle].clone(),
                                 m[idle].clone(), v[idle].clone()))
            out = real.update(grads, state, params)
            for p, m, v, idle, p0, m0, v0 in keep:
                p[idle], m[idle], v[idle] = p0, m0, v0
            return out

        return TO.Optimizer(real.init, update)

    return make


def _torch_optim_adamw(real_adamw):
    """``torch.optim.AdamW``'s arithmetic: a constant lr, no clip."""
    import math
    from repro_torch import pytree
    from repro_torch.train import optimizer as TO

    def make(cfg):
        real = real_adamw(cfg)

        @torch.no_grad()
        def update(grads, state, params):
            c = state["count"] + 1
            lr, n = cfg.learning_rate, int(c)
            for p, g, m, v in zip(*(pytree.leaves(t) for t in (
                    params, grads, state["m"], state["v"]))):
                p.mul_(1 - lr * cfg.weight_decay)
                m.mul_(0.9).add_(g, alpha=0.1)
                v.mul_(0.95).addcmul_(g, g, value=0.05)
                denom = (v.sqrt() / math.sqrt(1 - 0.95 ** n)).add_(1e-8)
                p.addcdiv_(m, denom, value=-lr / (1 - 0.9 ** n))
            return params, {"m": state["m"], "v": state["v"], "count": c}, \
                {"grad_norm": torch.zeros(()), "lr": torch.tensor(lr)}

        return TO.Optimizer(real.init, update)

    return make


@pytest.mark.parametrize("wrong", [_sparse_row_adamw, _torch_optim_adamw],
                         ids=["sparse_rows", "torch_optim"])
def test_chip_smoke_train_gate_refuses_another_adamw(train_small,
                                                     monkeypatch, wrong):
    from repro_torch.launch import train as TL
    from repro_torch.train import optimizer as TO
    monkeypatch.setattr(TO, "adamw", wrong(TO.adamw))
    with pytest.raises(AssertionError, match="AdamW's p != the reference"):
        train_small._dlrm_train_timed(torch.device("cpu"),
                                      TL.get_config("dlrm-rm2"))


def test_chip_smoke_train_gate_refuses_a_resume_that_restarts(train_small,
                                                              monkeypatch):
    """A train() that ignores its checkpoint starts run 2 over at step 0:
    it takes twice the forward passes, and the launch count refuses it."""
    from repro_torch.launch import train as TL
    real = TL.train
    monkeypatch.setattr(TL, "train", lambda arch, **kw: real(
        arch, **dict(kw, resume=False)))
    with pytest.raises(AssertionError, match="kernel 4 launched"):
        train_small._dlrm_train_runs(torch.device("cpu"),
                                     TL.get_config("dlrm-rm2"), 1 << 20)


def test_chip_smoke_train_only_runs_the_device_and_train_phases(
        smoke, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(smoke, "phase_device",
                        lambda: calls.append("device") or "stub card, 700 W")
    for name in ("phase_train", "phase_side", "phase_strings"):
        monkeypatch.setattr(smoke, name, lambda dev, n=name: calls.append(n))
    assert smoke.main(["--train-only"]) == 0
    assert calls == ["device", "phase_train"]
    out = capsys.readouterr().out
    assert '"ok"' not in out and "stub card, 700 W" in out


# ---------------------------------------------------------------------------
# phase 16: the launch layer
# ---------------------------------------------------------------------------

LAUNCH_SMALL_CELLS = [("llama3-8b", "decode_32k"), ("dlrm-rm2", "serve_p99"),
                      ("dlrm-rm2", "train_batch"), ("gin-tu", "molecule"),
                      ("cooccur-csl", "build_full"),
                      ("cooccur-csl", "query_bfs_d3"),
                      ("cooccur-csl", "stream_ingest")]


def _uncounted(fn):
    """A stand-in launcher whose plain ops the launch layer's counter does
    not see, as it sees no hand-written kernel."""
    from torch.utils._python_dispatch import _disable_current_modes

    def run(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)

    return run


@pytest.fixture
def launch_small(smoke, monkeypatch):
    """Phase launch on seven cells at reduced sizes (llama3-8b at the
    reference's reduced widths with batch 2 and 64 positions, dlrm-rm2 at
    1,000 rows a field, the CSL index at 256 terms and 1,500 docs, GIN's
    molecule cell as published), planned in this process; the stand-in
    launchers hidden from the counter."""
    import repro_torch.configs as C
    from repro_torch.configs import base, replace
    from repro_torch.kernels import dot_interaction, level_step, postings, ref

    def small(mod, **kw):
        m = __import__(C._ARCH_MODULES[mod], fromlist=["CONFIG"])
        monkeypatch.setattr(m, "CONFIG", replace(m.CONFIG, **kw))

    shapes = tuple(s if s.name != "decode_32k" else base.ShapeSpec(
        s.name, s.kind, dict(seq_len=64, global_batch=2))
        for s in C.get_config("llama3-8b").shapes)
    small("llama3-8b", **dict(LM_SMALL, n_kv_heads=2), shapes=shapes)
    small("dlrm-rm2", vocab_per_field=1000)
    small("cooccur-csl", vocab_size=256, n_docs=1500)
    monkeypatch.setattr(postings, "postings_counts_cuda",
                        _uncounted(ref.postings_counts_ref))
    monkeypatch.setattr(level_step, "level_step_cuda",
                        _uncounted(ref.level_step_ref))
    monkeypatch.setattr(dot_interaction, "dot_interaction_cuda",
                        _uncounted(ref.dot_interaction_ref))
    monkeypatch.setattr(smoke, "LAUNCH_CELLS", LAUNCH_SMALL_CELLS)
    monkeypatch.setattr(smoke, "LAUNCH_SUBPROCESS", False)
    return smoke


def test_chip_smoke_launch_phase_rehearses_on_the_cpu(launch_small, capsys):
    """Every cell plans on both placeholder meshes (the ingest cell stops
    on meta at its data-dependent dedup), every cell runs on the "card"
    (the CPU) with its FLOPs equal to the meta count, and the CSL query and
    ingest cells answer alike under "fused" and "pallas"."""
    launches = launch_small.phase_launch(torch.device("cpu"))
    assert launches["level_step"] > 0 and launches["postings_counts"] > 0
    # two cells (serve, train's forward), a counted step and 3 timed each
    assert launches["dot_interaction"] == 2 * 4
    text = capsys.readouterr().out
    assert text.count("[launch] cell=") == 7 + 7 + 2 * 2
    assert "cell=cooccur-csl/stream_ingest status=planned " \
           "program_peak_gb=" in text
    assert "args_gb_per_device_16x16=" in text
    assert "flops_per_dev_2x16x16=" in text
    assert "needs the data's values" in text
    assert "cell=dlrm-rm2/train_batch mesh=host-1x1 status=ok " in text
    assert "mesh=host-1x1-fused status=ok" in text
    assert "mesh=host-1x1-pallas status=ok" in text
    assert text.count("equal_to_gemm=True") == 4
    assert "[launch] cells_run=7 " in text


def test_chip_smoke_launch_gate_refuses_unequal_counts(launch_small,
                                                       monkeypatch):
    """A kernel that counts itself on the card but not on meta breaks the
    FLOP gate."""
    from repro_torch.kernels import ops
    real = ops.kernel_cost
    monkeypatch.setattr(ops, "kernel_cost", lambda name, *a, **k: (
        (real(name, *a, **k)[0] + (a[0].device.type != "meta"),
         real(name, *a, **k)[1])))
    monkeypatch.setattr(launch_small, "LAUNCH_CELLS",
                        [("dlrm-rm2", "serve_p99")])
    with pytest.raises(AssertionError, match="FLOPs on cpu"):
        launch_small.phase_launch(torch.device("cpu"))


def test_chip_smoke_launch_only_runs_the_device_and_launch_phases(
        smoke, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(smoke, "phase_device",
                        lambda: calls.append("device") or "stub card, 700 W")
    for name in ("phase_launch", "phase_train", "phase_strings"):
        monkeypatch.setattr(smoke, name, lambda dev, n=name: calls.append(n))
    assert smoke.main(["--launch-only"]) == 0
    assert calls == ["device", "phase_launch"]
    out = capsys.readouterr().out
    assert '"ok"' not in out and "stub card, 700 W" in out


# ---------------------------------------------------------------------------
# phases 17 and 18: ids out of range, the examples
# ---------------------------------------------------------------------------


@pytest.fixture
def ids_small(lm_small, monkeypatch):
    """Phase ids on 400 docs over 64 terms, llama at lm_small's widths,
    recommender batches of 64 and GIN over 128 nodes and 512 edges."""
    for name, value in [("IDS_DOCS", 400), ("IDS_TERMS", 64),
                        ("IDS_BATCH", 64), ("IDS_GIN", (128, 512)),
                        ("IDS_LM_NEW", 3), ("IDS_GRAD_TOKENS", 2048)]:
        monkeypatch.setattr(lm_small, name, value)
    return lm_small


def test_chip_smoke_ids_phase_rehearses_on_the_cpu(ids_small, capsys):
    launches = ids_small.phase_ids(torch.device("cpu"))
    assert launches["postings_counts"] > 0 and launches["level_step"] > 0
    assert launches["dot_interaction"] >= 2        # dlrm: bad, then clean
    out = capsys.readouterr().out
    assert out.count("[ids] path=cooc_server") == 2
    assert "good_streams_equal=True" in out
    assert "[ids] path=embed_grad " in out and "same_bits=True" in out
    for arch in ("dlrm-rm2", "deepfm", "sasrec"):
        assert f"[ids] path=serve_fn arch={arch}" in out
    assert "[ids] path=gin_forward" in out


def test_chip_smoke_ids_gate_refuses_a_raising_seed_gather(ids_small,
                                                          monkeypatch):
    """The tree before this phase's repair: the seed gather reads column
    V and raises (here first in the CPU's answer; on the card the lane's
    answer would be an error or a device assert)."""
    from repro_torch.core import cooccurrence as C
    real = C.initial_state

    def unclamped(index, seed_terms, **kw):
        s = torch.as_tensor(seed_terms).to(torch.int64)
        index.packed.index_select(1, s.clamp(min=0).reshape(-1))
        return real(index, seed_terms, **kw)

    monkeypatch.setattr(C, "initial_state", unclamped)
    with pytest.raises((AssertionError, RuntimeError),
                       match="out of DATA bounds|ids: gemm"):
        ids_small.phase_ids(torch.device("cpu"))


def test_chip_smoke_examples_phase_rehearses_on_the_cpu(smoke, monkeypatch,
                                                       capsys):
    monkeypatch.setattr(smoke, "EXAMPLES", (("torch_quickstart.py",),))
    smoke.phase_examples(torch.device("cpu"))
    out = capsys.readouterr().out
    assert "[examples] script=torch_quickstart.py rc=0" in out
    assert "[examples] scripts=1 ok=True" in out
    monkeypatch.setattr(smoke, "EXAMPLES", (("torch_quickstart.py",
                                             "--no-such-flag"),))
    with pytest.raises(AssertionError, match="examples failed"):
        smoke.phase_examples(torch.device("cpu"))


def test_chip_smoke_ids_only_runs_the_device_ids_and_examples_phases(
        smoke, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(smoke, "phase_device",
                        lambda: calls.append("device") or "stub card, 700 W")
    for name in ("phase_ids", "phase_examples", "phase_strings"):
        monkeypatch.setattr(smoke, name, lambda dev, n=name: calls.append(n))
    assert smoke.main(["--ids-only"]) == 0
    assert calls == ["device", "phase_ids", "phase_examples"]
    out = capsys.readouterr().out
    assert '"ok"' not in out and "stub card, 700 W" in out
