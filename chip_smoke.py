#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a host with a CUDA card and ``nvcc``:
it builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, serves the
paper's query at the CSL scale (396,209 docs, 65,536 terms, depth 3, top-k
16, beam 32, 8 queries per batch) through ``QueryContext`` and
``CoocEngine`` with the two kernel methods, and checks the answers against
the host oracle.  Phases:

  1. device     the card (``nvidia-smi``), the kernels' build
  2. parity     both kernels == their plain versions, exact, at small,
                ragged and mid shapes (2^15 docs x 2^13 terms, 256 rows);
                methods "gemm" and "popcount" served at the mid size
  3. strings    the quickstart corpus through ``CoocIndex(device="cuda")``
                for all four methods == the host oracle, then an ingest
  4. csl        the CSL-scale serving run, per kernel method
  5. kernels    each kernel timed at the main path's shapes beside its
                plain version, its bound and a PyTorch yardstick

Every phase raises on failure.  It prints one line per phase; the last
two lines are the kernels JSON and ``{"ok": true, "device": ...}``.  It
imports nothing of jax or of the reference package.  Without a CUDA
device, or outside a checkout, it exits non-zero before printing a result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# the bound of a kernel is the larger of its bytes over the memory rate and
# its popcounts over the integer pipe's rate
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
POPC_PER_CLOCK_PER_SM = 16     # CUDA programming guide, compute capability 9.0

CSL_DOCS, CSL_TERMS = 396_209, 65_536
DEPTH, TOPK, BEAM, Q_BATCH = 3, 16, 32, 8
N_QUERIES = 64
N_ORACLE = 8                   # queries per method held against the oracle
MID_DOCS, MID_TERMS = 1 << 15, 1 << 13

QUICKSTART = [
    "graph neural networks learn node embeddings from graph structure",
    "co-occurrence networks reveal semantic relationships in text corpora",
    "inverted index maps keywords to documents for fast retrieval",
    "breadth first search expands the network frontier level by level",
    "keyword co-occurrence networks support text mining and retrieval",
    "the inverted index makes co-occurrence network construction fast",
    "semantic networks and knowledge graphs organise scientific keywords",
    "fast retrieval of documents uses the inverted index keywords",
    "text mining extracts keywords and builds co-occurrence networks",
    "network construction from an inverted index runs in real time",
]


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def oracle_edges(hidx, seeds, depth, topk, beam):
    from repro_torch.core import bfs_construct_host_fast
    out = {}
    for s, d, w in bfs_construct_host_fast(hidx, seeds, depth=depth,
                                           topk=topk, beam=beam):
        key = (min(s, d), max(s, d))
        out[key] = max(out.get(key, 0), w)
    return out


def check_network(res, v):
    net = res.network
    n = res.spec.max_edges
    for a in net:
        if a.shape != (n,):
            raise AssertionError(f"network slot shape {a.shape} != ({n},)")
    ok = net.valid.astype(bool)
    if (net.weight[ok] <= 0).any() or (net.weight[~ok] != 0).any():
        raise AssertionError("edge weights break the valid-slot contract")
    if ok.any() and (net.dst[ok].max() >= v or net.dst[ok].min() < 0):
        raise AssertionError("edge target outside the vocabulary")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch
    from repro_torch.kernels import build
    card = smi("name,power.limit")
    print(card, flush=True)
    t0 = time.perf_counter()
    logs = build.build()
    secs = time.perf_counter() - t0
    regs = {name: [ln.split("info    : ")[-1] for ln in log.splitlines()
                   if "registers" in ln] for name, log in logs.items()}
    say("device", kind=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, build_s=f"{secs:.2f}",
        ptxas=json.dumps(regs))
    return card


def _level_args(rng, q, b, v, w, dev, density=0.8):
    from repro_torch.core import from_uint32
    import torch
    r = q * b
    packed = rng.integers(0, 1 << 32, (w, v), dtype=np.uint32)
    masks = rng.integers(0, 1 << 32, (r, w), dtype=np.uint32)
    masks[rng.random((r, w)) >= density] = 0
    return (from_uint32(masks, dev), from_uint32(packed, dev),
            torch.from_numpy(rng.integers(-1, v, r)).to(dev),
            torch.from_numpy(rng.integers(0, 2, r).astype(bool)).to(dev),
            torch.from_numpy(rng.integers(0, 2, (q, v)).astype(bool)).to(dev))


def _check_level(masks, pt, terms, valid, visited, v, k, dedup):
    import torch
    from repro_torch.kernels import ops, ref
    got_w, got_i = ops.level_step(masks, pt, terms, valid, visited, v=v, k=k,
                                  dedup=dedup)
    k_eff = min(k, v)
    want_w, want_i = ref.level_step_ref(masks, pt, terms, valid, visited,
                                        v=v, k=k_eff, dedup=dedup)
    if not (torch.equal(got_w[:, :k_eff], want_w)
            and torch.equal(got_i[:, :k_eff], want_i)
            and bool((got_w[:, k_eff:] == -1).all())
            and bool((got_i[:, k_eff:] == 0).all())):
        raise AssertionError(f"level_step kernel != plain version at "
                             f"rows={masks.shape[0]} v={v} k={k} "
                             f"dedup={dedup}")


def phase_parity(dev):
    """Both kernels against their plain versions on the card; then the
    plain methods "gemm" and "popcount" served at the mid size."""
    import torch
    from repro_torch.core import QueryContext, build_host_index
    from repro_torch.core.cooccurrence import _expand_level, initial_state
    from repro_torch.core.query_context import pad_transposed
    from repro_torch.data import synthetic_csl
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import CoocEngine

    rng = np.random.default_rng(0)
    cases = 0
    # small and ragged postings shapes
    for b, w, v in [(1, 1, 9), (37, 70, 515), (256, 300, 2049)]:
        masks, packed, *_ = _level_args(rng, 1, b, v, w, dev)
        if not torch.equal(ops.postings_counts(masks, packed),
                           ref.postings_counts_ref(masks, packed)):
            raise AssertionError(f"postings kernel != plain at {(b, w, v)}")
        cases += 1
    # level step: ragged, k > v, dedup off, invalid rows, pad columns,
    # k above the column tile, batch-major visited
    for q, b, v, w, k, dedup in [(1, 5, 97, 7, 6, True),
                                 (1, 3, 40, 3, 50, False),
                                 (4, 16, 1000, 130, 16, True),
                                 (2, 8, 300, 40, 200, True)]:
        masks, packed, terms, valid, visited = _level_args(rng, q, b, v, w,
                                                           dev)
        _check_level(masks, pad_transposed(packed), terms, valid, visited,
                     v, k, dedup)
        cases += 1
    # forced ties: identical postings columns, every count equal
    masks, packed, terms, valid, visited = _level_args(rng, 1, 8, 300, 5, dev)
    packed = packed[:, :1].repeat(1, 300).contiguous()
    _check_level(masks, pad_transposed(packed), terms, valid, visited,
                 300, 16, True)
    # pad columns: every real column visited, so all real counts are -1
    _check_level(masks, pad_transposed(packed), terms, torch.ones_like(valid),
                 torch.ones_like(visited), 300, 16, True)
    cases += 2

    # mid size: a real index and a real level-1 frontier of 256 rows
    docs = synthetic_csl(MID_DOCS, MID_TERMS, seed=1)
    ctx = QueryContext.from_docs(docs, MID_TERMS, device=dev)
    df = ctx.index.doc_freq.cpu().numpy()
    seeds = np.argsort(-df, kind="stable")[:Q_BATCH].reshape(Q_BATCH, 1)
    st = initial_state(ctx.index, torch.from_numpy(seeds), beam=BEAM)
    st, _ = _expand_level(ctx.index, st, Q_BATCH, TOPK, True, "fused",
                          ctx.operands("fused"))
    got = ops.postings_counts(st.masks, ctx.index.packed)
    if not torch.equal(got, ref.postings_counts_ref(st.masks,
                                                    ctx.index.packed)):
        raise AssertionError("postings kernel != plain at the mid size")
    _check_level(st.masks, ctx.packed_t_pad(), st.terms, st.valid,
                 st.visited, MID_TERMS, TOPK, True)
    cases += 2
    say("parity", cases=cases, exact=True,
        mid_rows=st.masks.shape[0], mid_words=ctx.index.n_words,
        mid_terms=MID_TERMS)

    # the plain methods at the mid size, held against the host oracle
    hidx = build_host_index(docs, MID_TERMS)
    qseeds = [int(s) for s in np.argsort(-df, kind="stable")[:8]]
    for method in ("gemm", "popcount"):
        eng = CoocEngine(ctx, device=dev, depth=DEPTH, topk=TOPK, beam=BEAM,
                         q_batch=Q_BATCH, method=method)
        t0 = time.perf_counter()
        futs = [eng.submit([s]) for s in qseeds]
        eng.run_until_drained()
        secs = time.perf_counter() - t0
        for s, f in zip(qseeds[:4], futs):
            res = f.result()
            check_network(res, MID_TERMS)
            if res.edges() != oracle_edges(hidx, [s], DEPTH, TOPK, BEAM):
                raise AssertionError(f"method {method} != host oracle, "
                                     f"seed {s}")
        extra = ({"x_dense_gb": f"{ctx.x_dense().nbytes / 1e9:.3f}",
                  "x_dense_dtype": str(ctx.x_dense().dtype)}
                 if method == "gemm" else {})
        say("parity", method=method, queries=len(qseeds), oracle_checked=4,
            batch_s=f"{secs:.4f}", **extra)
    # a mid-size yardstick: one bf16 matmul of the unpacked operands
    from repro_torch.core import unpack_bitmap
    x16 = unpack_bitmap(ctx.index.packed.T.contiguous(),
                        torch.bfloat16).T.contiguous()
    m16 = unpack_bitmap(st.masks, torch.bfloat16)
    mm_ms = cuda_ms(lambda: torch.matmul(m16, x16), 5)
    k_ms = cuda_ms(lambda: ops.postings_counts(st.masks, ctx.index.packed), 5)
    say("parity", mid_postings_kernel_ms=f"{k_ms:.4f}",
        mid_bf16_matmul_ms=f"{mm_ms:.4f}")
    del x16, m16, ctx
    torch.cuda.empty_cache()


def phase_strings(dev):
    from repro_torch.api import CoocIndex
    from repro_torch.core import build_host_index
    from repro_torch.data import build_lexicon
    from repro_torch.kernels import ops

    lex, docs = build_lexicon(QUICKSTART)
    hidx = build_host_index(docs, len(lex))
    want = {(lex.id_to_term[a], lex.id_to_term[b]): w
            for (a, b), w in oracle_edges(hidx, [lex.lookup("networks")],
                                          2, 6, 8).items()}
    ops.reset_launches()
    for method in ("gemm", "popcount", "pallas", "fused"):
        idx = CoocIndex.from_texts(QUICKSTART, device=dev, depth=2, topk=6,
                                   beam=8, q_batch=4, method=method)
        edges = idx.network(["networks"])
        if edges != want:
            raise AssertionError(f"quickstart network ({method}) != oracle")
        idx.add_documents(["inverted index networks accelerate retrieval"] * 2)
        grown = idx.network(["accelerate"], depth=1)
        if grown.get(("networks", "accelerate")) != 2:
            raise AssertionError(f"ingest not visible ({method}): {grown}")
    launches = dict(ops.LAUNCHES)
    if launches["postings_counts"] == 0 or launches["level_step"] == 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    say("strings", methods=4, edges=len(want), oracle=True,
        ingest_visible=True, launches=json.dumps(launches))


def phase_csl(dev):
    """The main path at the paper's scale, once per kernel method."""
    import torch
    from repro_torch.core import QueryContext, build_host_index
    from repro_torch.data import synthetic_csl
    from repro_torch.kernels import ops
    from repro_torch.serve import CoocEngine

    t0 = time.perf_counter()
    docs = synthetic_csl(CSL_DOCS, CSL_TERMS, seed=0)
    t_gen = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx = QueryContext.from_docs([], CSL_TERMS, capacity=CSL_DOCS, device=dev)
    ctx.ingest_docs(docs)
    ctx.packed_t_pad()
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    if ctx.n_docs != CSL_DOCS or ctx.index.n_words != (CSL_DOCS + 31) // 32:
        raise AssertionError(f"ingest gave n_docs={ctx.n_docs}, "
                             f"W={ctx.index.n_words}")
    df = ctx.index.doc_freq.cpu().numpy()
    say("csl", docs=CSL_DOCS, terms=CSL_TERMS, words=ctx.index.n_words,
        gen_s=f"{t_gen:.2f}", ingest_s=f"{t_ingest:.2f}",
        packed_gb=f"{ctx.index.packed.numel() * 4 / 1e9:.3f}",
        packed_t_pad_shape=tuple(ctx.packed_t_pad().shape))

    # head and tail seeds (df > 0), four of each in every batch of eight
    rng = np.random.default_rng(0)
    head = rng.choice(np.argsort(-df, kind="stable")[:256], N_QUERIES // 2,
                      replace=False)
    tail = rng.choice(np.flatnonzero((df >= 1) & (df <= 64)), N_QUERIES // 2,
                      replace=False)
    seeds = [int(x) for pair in zip(head.reshape(-1, 4), tail.reshape(-1, 4))
             for half in pair for x in half]
    t0 = time.perf_counter()
    hidx = build_host_index(docs, CSL_TERMS)
    oracle = {s: oracle_edges(hidx, [s], DEPTH, TOPK, BEAM)
              for s in seeds[:N_ORACLE]}
    say("csl", oracle_queries=N_ORACLE,
        oracle_s=f"{time.perf_counter() - t0:.2f}",
        seed_df_head=int(df[seeds[0]]), seed_df_tail=int(df[seeds[4]]))

    launches = {}
    for method, counter in (("fused", "level_step"),
                            ("pallas", "postings_counts")):
        eng = CoocEngine(ctx, device=dev, depth=DEPTH, topk=TOPK, beam=BEAM,
                         q_batch=Q_BATCH, method=method)
        eng.query([seeds[0]])            # first use: allocator, caches
        ops.reset_launches()
        futs = [eng.submit([s]) for s in seeds]
        batch_ms = []
        t0 = time.perf_counter()
        while eng.queue:
            tb = time.perf_counter()
            eng.step()
            batch_ms.append((time.perf_counter() - tb) * 1e3)
        secs = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        if counts[counter] == 0:
            raise AssertionError(f"method {method} never launched {counter}")
        launches[counter] = counts[counter]
        for s, f in zip(seeds, futs):
            res = f.result()
            check_network(res, CSL_TERMS)
            if s in oracle and res.edges() != oracle[s]:
                raise AssertionError(f"CSL {method} != host oracle, seed {s}")
        p50, p99 = np.percentile(batch_ms, [50, 99])
        say("csl", method=method, queries=len(seeds),
            batches=len(batch_ms), qps=f"{len(seeds) / secs:.3f}",
            batch_p50_ms=f"{p50:.3f}", batch_p99_ms=f"{p99:.3f}",
            launches=json.dumps(counts),
            launches_per_batch=f"{counts[counter] / len(batch_ms):.2f}",
            oracle_matched=N_ORACLE)
    say("csl", max_memory_allocated_gb=
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    return ctx, seeds, launches


def _bound(nonzero_words, active_words, out_bytes, mask_bytes, v, sms, hz):
    """The least time for the work these inputs need: each nonzero mask
    word against every column (popcounts) and each packed word row that
    some nonzero mask word selects (bytes)."""
    ops_ = nonzero_words * v
    bytes_ = mask_bytes + active_words * v * 4 + out_bytes
    t_ops = ops_ / (sms * POPC_PER_CLOCK_PER_SM * hz)
    t_bytes = bytes_ / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops_, bytes_)


def phase_kernels(dev, ctx, seeds, launches):
    """Each kernel at the main path's shapes: a level-1 frontier of the
    first CSL batch, through the same code the engine runs."""
    import torch
    from repro_torch.core import unpack_bitmap
    from repro_torch.core.cooccurrence import _expand_level, initial_state
    from repro_torch.kernels import ops, ref

    seed_rows = torch.tensor(seeds[:Q_BATCH]).reshape(Q_BATCH, 1)
    st = initial_state(ctx.index, seed_rows, beam=BEAM)
    st, _ = _expand_level(ctx.index, st, Q_BATCH, TOPK, True, "fused",
                          ctx.operands("fused"))
    packed, pt = ctx.index.packed, ctx.packed_t_pad()
    r, w = st.masks.shape
    v = ctx.vocab_size
    nz = st.masks != 0
    nonzero_words = int(nz.sum())
    active_words = int(nz.any(dim=0).sum())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    say("kernels", rows=r, words=w, terms=v, nonzero_mask_words=nonzero_words,
        active_words=active_words, sms=sms, max_sm_mhz=hz / 1e6)
    out = []

    # postings counts
    got = ops.postings_counts(st.masks, packed)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    want = ref.postings_counts_ref(st.masks, packed, chunk_bytes=2 << 30)
    t1.record()
    t1.synchronize()
    plain_ms = t0.elapsed_time(t1)
    err = int((got - want).abs().max())
    if err != 0:
        raise AssertionError("postings kernel != plain at the CSL shapes")
    del got, want
    ms = cuda_ms(lambda: ops.postings_counts(st.masks, packed), 5)
    bound_ms, bound_by, n_ops, n_bytes = _bound(
        nonzero_words, active_words, r * v * 4, r * w * 4, v, sms, hz)
    # yardstick (not used by the port): one int8 tensor-core product of the
    # unpacked 0/1 operands, exact in int32 like the kernel; the (V, D)
    # incidence is unpacked from the transposed postings 1,024 terms at a
    # time and handed over column-major
    torch.cuda.empty_cache()
    x8 = torch.empty((v, w * 32), dtype=torch.int8, device=dev)
    for v0 in range(0, v, 1024):
        x8[v0:v0 + 1024] = unpack_bitmap(pt[v0:v0 + 1024, :w], torch.int8)
    m8 = unpack_bitmap(st.masks, torch.int8)
    lib = torch._int_mm(m8, x8.t())
    lib_err = int((lib - ops.postings_counts(st.masks, packed)).abs().max())
    del lib
    lib_ms = cuda_ms(lambda: torch._int_mm(m8, x8.t()), 3)
    del x8, m8
    torch.cuda.empty_cache()
    out.append({"name": "postings_counts", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/postings.cu",
                "replaces": "src/repro/kernels/postings.py:37",
                "launches": launches["postings_counts"], "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms})
    say("kernels", kernel="postings_counts", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, popcounts=n_ops, bytes=n_bytes,
        int8_mm_ms=f"{lib_ms:.4f}", int8_mm_max_abs_err=lib_err)

    # fused level step
    args = (st.masks, pt, st.terms, st.valid, st.visited)
    got = ops.level_step(*args, v=v, k=TOPK, dedup=True)
    t0.record()
    want = ref.level_step_ref(*args, v=v, k=TOPK, dedup=True,
                              chunk_bytes=2 << 30)
    t1.record()
    t1.synchronize()
    plain_ms = t0.elapsed_time(t1)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("level_step kernel != plain at the CSL shapes")
    err = int((got[0] - want[0]).abs().max())
    ms = cuda_ms(lambda: ops.level_step(*args, v=v, k=TOPK, dedup=True), 5)
    vis_bytes = st.visited.numel() + 2 * r * 4      # visited, terms, valid
    bound_ms, bound_by, n_ops, n_bytes = _bound(
        nonzero_words, active_words, 2 * r * TOPK * 4 + vis_bytes, r * w * 4,
        v, sms, hz)
    out.append({"name": "level_step", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/level_step.cu",
                "replaces": "src/repro/kernels/level_step.py:109",
                "launches": launches["level_step"], "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None})
    say("kernels", kernel="level_step", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, popcounts=n_ops, bytes=n_bytes)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = phase_device()
    phase_parity(dev)
    phase_strings(dev)
    ctx, seeds, launches = phase_csl(dev)
    kernels = phase_kernels(dev, ctx, seeds, launches)
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
