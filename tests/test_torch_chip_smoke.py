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
                                     level_step, ops, postings, ref)
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
    for name, value in [("CSL_DOCS", 1500), ("CSL_TERMS", 256),
                        ("MID_DOCS", 1024), ("MID_TERMS", 128),
                        ("N_QUERIES", 16), ("DLRM_VOCAB", 1000),
                        ("SHA_PROBE_BYTES", 1 << 20),
                        ("SERVE_P99", 16), ("SERVE_BULK", 96),
                        ("RETRIEVAL_CAND", 300), ("N_P99_BATCHES", 5),
                        ("DECODE_HEADS", (8, 2, 16)),
                        ("DECODE_SHAPES", {"decode_32k": (3, 100),
                                           "long_500k": (1, 300)})]:
        monkeypatch.setattr(chip_smoke, name, value)
    return chip_smoke


def test_chip_smoke_phases_rehearse_on_the_cpu(smoke, capsys):
    dev = torch.device("cpu")
    smoke.phase_parity(dev)
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
                                            "cooccur_counts"]
    assert [k["launches"] for k in kernels] == [6, 6, 1]
    for k in kernels:
        assert set(k) == KEYS
        assert k["max_abs_err"] == 0
        assert (ROOT / k["source"]).is_file()
        assert k["bound_ms"] > 0 and k["bound_by"] in ("bytes", "operations")
    assert kernels[2]["bound_by"] == "bytes"
    assert ctx.unpack_count == 1        # the yardsticks reuse x_dense
    out = capsys.readouterr().out
    assert "[csl] method=fused" in out and "[csl] method=pallas" in out
    assert "[materialize] method=pallas" in out
    assert "[materialize] method=gemm" in out
    # kernel 4's parity: 16 cases; the plain path takes the two unaligned
    # views and the three shapes whose rows are not whole 16-byte words
    assert 'dot_interaction_cases={"bulk": 11, "plain": 5}' in out
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
    assert "materialize_methods=4 identical=True" in out
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
# phase 14: the LM serving path
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
    monkeypatch.setattr(smoke, "phase_parity", lambda dev: calls.append(
        "parity"))
    assert smoke.main(["--lm-only"]) == 0
    assert calls == ["device", "lm"]
    out = capsys.readouterr().out
    assert '"ok"' not in out and "stub card, 700 W" in out
