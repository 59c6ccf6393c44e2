#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Three commands cover the port on the card:

- ``PYTHONPATH=src python3 -m pytest -q -m gpu tests/test_torch_gpu.py``
  holds each hand-written kernel against its plain PyTorch version;
- ``python3 -m portbench.run --workload <cell>`` measures the cells of
  ``BENCHMARK.json`` (``csl-network``, ``medline-network``, ``csl-batch``);
- this script measures the paths and kernels that have no cell there, and
  writes the kernel table (the kernels JSON of its last lines).

Run from the root of a checkout on a host with a CUDA card and ``nvcc``:
it builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
serves the paper's query at the CSL scale (396,209 docs, 65,536 terms,
depth 3, top-k 16, beam 32, 8 queries per batch) through ``QueryContext``
and ``CoocEngine`` with the two BFS kernel methods, materializes the whole
CSL network (top-16 per term) exactly through the co-occurrence kernel and
approximately through the postings kernel, checks the answers against the
host oracle, serves and materializes the same index on a term and a doc
mesh of four shards of the card, saves a streaming CSL ring on local disk
and warm-starts the multi-tenant ``CoocServer`` from it, which serves an
open-loop trace.
Then it serves dlrm-rm2 at full size
through the dot-interaction kernel, runs the flash-decode kernel at
llama3-8b's decode cells, serves llama3-8b and deepseek-v2-lite-16b
at full size through the LM decode server, serves DeepFM, SASRec,
BERT4Rec and GIN at their published widths, trains, and plans the
reference's dry-run cells and runs those that fit the card.  Last, it
answers ids out of range on each path as the reference does and runs
the port's examples.  Phases:

  1. device       the card (``nvidia-smi``), the kernels' build
  2. strings      the quickstart corpus through ``CoocIndex(device="cuda")``
                  for all four methods == the host oracle (queries, the
                  whole network and its statistics), then an ingest; the
                  index saved and loaded back answers like the live one,
                  its approx network equals the CPU's, and the snapshot's
                  blobs match their manifest's sha256; then on a term
                  and a doc mesh of MESH_SHARDS shards of the card: all
                  four methods, queries and the whole network (both
                  shard strategies) == the oracle, live and restored
                  (``CoocIndex.load(mesh=)``), 8 requests through
                  ``CoocServer.from_snapshot(mesh=)`` == a direct
                  engine, and ``CoocIndex(devices=1)`` a one-shard mesh
  3. csl          the CSL-scale serving run, per BFS kernel method
  4. materialize  the whole CSL network, method "pallas" (the kernel, one
                  launch a chunk of a row group's documents, on its TMA
                  path) and
                  "gemm" (``torch._int_mm``): identical, 16 rows == the
                  host oracle
  5. approx       the approximate CSL sweep (k 16, threshold 0.5, 128
                  permutations): signatures, host banding, each row block
                  counted against its candidates through kernel 1
                  ("pallas") and ``torch._int_mm`` ("gemm"): identical;
                  every emitted weight == its pair's count; 64 signatures
                  == numpy
  6. kernels      each CSL kernel timed at the main path's shapes beside
                  its plain version, its bound and a PyTorch yardstick
                  (kernels 1 and 2 at the level-0, level-1 and level-2
                  frontiers of the first batch, kernel 1 with the work its
                  row tiles walk and its compaction launch's time; kernel
                  3 and ``torch._int_mm`` at 1, 2, 4 and 8 row blocks a
                  launch; the row top-k on a row group's counts at
                  65,536 and 30,454 terms beside ``torch.topk`` over
                  int64 keys)
  7. mesh         the CSL index on a term and a doc mesh of MESH_SHARDS
                  shards of the card, each answer == the unsharded one
                  of this run: the 64 queries under "fused" and "pallas"
                  (one launch a level per shard: kernel 2 on the term
                  mesh's "fused", kernel 1 otherwise), the whole network
                  ("rows" and "cols" on the term mesh, the doc split on
                  the doc mesh; kernel 3 on its TMA path), the approx
                  network and the signatures (term mesh); a profiled
                  batch per mesh and method; then the CSL context is
                  freed
  8. stream       the streaming tier at the stream_ingest cell: a window of
                  396,209 CSL docs (capacity pinned at 396,224 slots)
                  filled in blocks of 4,096, then 8 rounds of 4,096 new
                  docs tagged "rounds", each evicting and spilling the
                  oldest block to a cold store, each followed by a "fused"
                  batch; the live docs' doc_freq and queries ("fused",
                  "pallas") == the host oracle; the scope="all-time"
                  network (kernel 3 over the live and cold tiers stacked)
                  == that of a fresh context over all 428,977 docs; one
                  "gemm" rebuild timed
  9. snapshot     the stream's ring (97 live blocks, 8 cold) sketched, its
                  all-time approx network built (kernel 1), saved to local
                  disk (about 6.8 GB) and loaded back on the card by the
                  serve phase's warm start: equal bits, doc_freq, ring,
                  scopes and cold payloads; no block rehashed; the same
                  "fused" batch and approx network; one more evicting
                  ingest leaves both identical
 10. serve        ``CoocServer.from_snapshot`` of that directory serving
                  three tenants: alpha pinned to "rounds" and beta
                  unscoped on the shared lane ("fused", kernel 2), gamma on
                  a dedicated 2^15-doc x 2^13-term context ("pallas",
                  kernel 1); capacity from 16 full batches of each hot plan
                  (depth 2 and 3, top-k 16, beam 32); then the reference
                  serving bench's open-loop trace at half of it (2,048
                  Poisson requests, a 256-request burst, 6 hostile one-off
                  plans, 4 evicting ingests of 4,096 docs) held to its
                  acceptance (burst shed at queue_full, depth <= 64, 4
                  executors a lane with evictions, no errors, misses under
                  1%); 64 served requests == a direct engine before and
                  after, 8 of gamma's == the host oracle; a never-seen
                  plan's first step; one full batch under the profiler
 11. dlrm         dlrm-rm2 (26 x 10^6 x 64 fp32 table) built from a seeded
                  generator, served at serve_p99, serve_bulk and
                  retrieval_cand through kernel 4, 64 rows of each held
                  against float64; kernel 4 and torch.bmm's full Gram
                  timed at each cell's interaction input, the kernels' own
                  device time (profiler) apart from the host time a call
 12. decode       kernel 5 through ``ops.flash_decode`` at decode_32k and
                  long_500k, ragged lengths (a 0 and a 1 among them) ==
                  the plain version; then timed at full lengths
 13. lm           the language-model serving path, which runs none of the
                  five kernels (the reference decodes through its plain
                  ``decode_attn``): llama3-8b (GQA, 32 layers) and
                  deepseek-v2-lite-16b (MLA, 64 experts top-6 and 2
                  shared) at full width and depth, bf16 weights from a
                  seeded generator, each through
                  ``DecodeServer(slots=8, max_len=256)`` (16 and 8
                  prompts of 16-128 tokens from ``lm_batch``, 32 and 16
                  new tokens); every request ends with its tokens; two
                  requests' decode logits, step by step, == a fresh
                  ``prefill`` over the prompt and the tokens so far
                  (LM_DECODE_TOL); prefill and decode-step times,
                  tokens/s, peak memory, a step's bytes bound and one
                  profiled step; then each arch at 2 layers, fp32, on the
                  card and through the port on the CPU: identical greedy
                  tokens, logits within LM_CPU_TOL; no kernel launch
                  count moves
 14. side         the seed's side models at their published widths, fp32
                  weights from a seeded generator, none of the five
                  kernels on their paths: deepfm (39 x 10^6 x 10 table),
                  sasrec and bert4rec (10^6 + 2 items) served at
                  serve_p99 (with SIDE_CANDIDATES candidates a sequence),
                  serve_bulk (bert4rec in slices of SIDE_BULK_SLICE) and
                  retrieval_cand (one sequence against 10^6 candidates),
                  64 rows of each cell == a float64 numpy recomputation;
                  gin-tu at every GNN_SHAPES cell: ogb_products
                  (2,449,029 nodes, 61,859,140 edges, full-graph
                  node_loss; its layer-1 aggregate of 64 nodes == float64
                  sums over the CSR; two runs compared bit for bit),
                  minibatch_lg (build_csr and sample_subgraph over a
                  114,615,892-edge graph, 1,024 seeds, fanouts 15 and 10,
                  node_loss with edge_mask), molecule (128 graphs,
                  graph_loss) and full_graph_sm, molecule's and
                  full_graph_sm's logits == a float64 numpy forward;
                  p50 a call, samples or nodes a second, peak memory,
                  bytes and operations bounds, profiled calls; then
                  each arch at the reference's reduced_config size on
                  the card == the port on the CPU (SIDE_CPU_TOL); no
                  kernel launch count moves
 15. train        training through ``repro_torch.launch.train.train``:
                  dlrm-rm2 at full size (26 x 10^6 x 64 fp32 table, AdamW
                  fp32 moments, batch 65,536) for 10 steps with a
                  checkpoint at step 10 (on local disk, removed after),
                  resumed to step 20, and 20 steps uninterrupted: the
                  resumed run's last loss == the uninterrupted one's;
                  kernel 4 launched once a forward pass; one step's
                  gradients through kernel 4 == through its plain version
                  on the card; kernel 4's backward (plain PyTorch, as the
                  reference has no backward kernel) on 4,096 samples ==
                  float64 on the CPU; AdamW on sampled table rows, touched
                  and untouched by the batch, == the reference's update in
                  float64; step ms p50 and p99, samples a second, peak
                  memory, one profiled step and the step's bytes bound;
                  save and restore seconds; then llama3-8b at full width
                  and 2 of its 32 layers (fp32 weights and moments, batch
                  4 x 1,024 tokens): a step's loss and gradients with
                  remat on == off, 5 timed steps beside the 6ND
                  operations bound; then every arch but cooccur-csl at
                  the reference's reduced_config through ``train()`` on
                  the card and on the CPU from one step-0 checkpoint:
                  losses and step-3 weights within TRAIN_CPU_TOL
 16. launch       the launch layer's dry-run (``repro_torch.launch``):
                  all 44 of the reference's cells planned on its 16x16
                  and 2x16x16 production meshes of ``meta`` placeholders
                  (one process a cell), each counted once on a
                  one-device ``meta`` mesh: every LM, recsys and GNN cell
                  "ok", a co-occurrence cell "ok" or "planned" with the
                  op that stopped it; then each cell whose planned peak
                  fits the card run on it at full size from seeded
                  inputs: the counted FLOPs == the meta count, the model
                  FLOPs and bytes == the plan's, every output finite; the
                  CSL query and ingest cells again under "fused" (kernel
                  2) and "pallas" (kernel 1), answers == "gemm"'s; each
                  run's median step of 3, peak against its planned peak,
                  and the model's time over the step's, beside the
                  card's name and power limit

Every phase raises on failure.  It prints one line per phase; the last
two lines are the kernels JSON and ``{"ok": true, "device": ...}``.  It
imports nothing of jax or of the reference package.  Without a CUDA
device, or outside a checkout, it exits non-zero before printing a result.

 17. ids          ids out of range on the card, each path used again in
                  the same process after it: a CoocServer lane, unsharded
                  and on a term mesh of MESH_SHARDS shards, takes one
                  batch under all four methods mixing seeds V and V + 3
                  with good ones (4,000 CSL-shaped docs, 1,024 terms),
                  then a later query: every answer == ``construct`` on
                  the CPU; llama3-8b at full width and 2 layers (bf16)
                  serves a prompt with a token past the vocab among good
                  ones: its stream all 0, the others == a run without it;
                  dlrm-rm2 (through kernel 4), deepfm and sasrec
                  ``serve_fn`` with bad ids in a few samples and GIN over
                  a bad edge: NaN exactly where the CPU puts it, the rest
                  within IDS_CPU_TOL; a synchronize after each, so that an
                  asynchronous device assert would surface in the phase
 18. examples     the port's nine examples (``examples/torch_*.py``) at
                  their smallest arguments, each in its own process on
                  the card, EXAMPLES_JOBS at a time: each exits 0

``python3 chip_smoke.py --dlrm-only`` runs phases 1 and 11 alone, to
compare kernel 4 between two trees on one card, and prints no result line;
``--lm-only`` runs phases 1 and 13 alone and ``--side-only`` phases 1
and 14 alone, ``--train-only`` phases 1 and 15 alone, ``--launch-only``
phases 1 and 16 alone, ``--ids-only`` phases 1, 17 and 18 alone; none
of them prints a result line.  Every phase
but 15, 16 and 18 serves, and runs without an autograd graph.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
import weakref
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# the bound of a kernel is the larger of its bytes over the memory rate and
# its operations over their unit's rate; the H100 SXM data sheet's rates of
# HBM3 and of dense bf16 tensor cores come from the port's launch layer
# (the checkout's src/, which main() checks for before anything runs)
if (ROOT / "src" / "repro_torch").is_dir():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
    from repro_torch.launch.mesh import (  # noqa: E402
        PEAK_FLOPS_BF16 as BF16_OPS_PER_S)
POPC_PER_CLOCK_PER_SM = 16     # CUDA programming guide, compute capability 9.0
INT8_OPS_PER_S = 1.979e15      # H100 SXM data sheet, dense int8 tensor cores

CSL_DOCS, CSL_TERMS = 396_209, 65_536
DEPTH, TOPK, BEAM, Q_BATCH = 3, 16, 32, 8
N_QUERIES = 64
N_ORACLE = 8                   # queries per method held against the oracle
MID_DOCS, MID_TERMS = 1 << 15, 1 << 13
MAT_K, ROW_TILE = 16, 128      # materialization: top-k per term, row block
MESH_TERMS = 30_454            # MeSH 2024 descriptors (medline-network)
N_SIGS_CHECKED = 64            # CSL signatures held against numpy
SHA_PROBE_BYTES = 1 << 30      # bytes hashed to time the host's sha256
N_ROWS_CHECKED = 16            # materialized CSL rows held against the oracle
MESH_SHARDS = 4                # shards of the mesh phases, all on one card
# the streaming tier at the reference's stream_ingest cell
# (src/repro/configs/base.py COOC_SHAPES): a window of the CSL corpus,
# 4,096 new docs an ingest, then a depth-2 query batch
STREAM_WINDOW, STREAM_BLOCK, STREAM_ROUNDS, STREAM_DEPTH = 396_209, 4_096, 8, 2
# the serving tier on that ring, warm-started from its snapshot, in the
# shape of the reference's serving bench (benchmarks/bench_serving.py):
# hot plans (depth, top-k, beam) = the stream cell's query and the paper's
# CSL query; a plan never seen, for its first step against its next
SERVE_HOT, SERVE_NEW = ((2, 16, 32), (3, 16, 32)), (2, 12, 24)
SERVE_QUEUE, SERVE_WAIT_MS, SERVE_BUDGET = 64, 250.0, 4
SERVE_DEADLINE_MS, SERVE_LINGER_MS = 500.0, 2.0
SERVE_CAPACITY_BATCHES = 16    # full batches of each hot plan, closed loop
SERVE_LOAD = 0.5               # steady arrival rate, of the capacity
SERVE_STEADY, SERVE_BURST, SERVE_HOSTILE, SERVE_INGESTS = 2048, 256, 6, 4
SERVE_CHECKED = 32             # requests of each hot plan held to an engine
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, fp32 outside the tensor cores

# dlrm-rm2 at full size, RECSYS_SHAPES' serving cells
DLRM_VOCAB = 1_000_000         # rows per sparse field (the published size)
SERVE_P99, SERVE_BULK, RETRIEVAL_CAND = 512, 262_144, 1_000_000
N_P99_BATCHES, N_BULK_BATCHES = 50, 3
N_DLRM_CHECKED = 64            # rows of each output held against float64
# fp32 through seven layers against a float64 recomputation of the rows
DLRM_RTOL, DLRM_ATOL = 1e-4, 1e-5
# kernel 4's device time: calls a profiled window, enough at serve_p99 that
# the few-microsecond kernel is timed over many launches; host time: calls
DOT_DEVICE_CALLS = {"serve_p99": 200, "serve_bulk": 20, "retrieval_cand": 10}
DOT_HOST_CALLS = 1000

# llama3-8b's attention widths at LM_SHAPES' decode cells: (B, S)
DECODE_HEADS = (32, 8, 128)    # Hq, Hkv, d
DECODE_SHAPES = {"decode_32k": (128, 32_768), "long_500k": (1, 524_288)}
# fp32: the reference's tolerance.  bf16: both sides sum in fp32 from the
# same inputs and round once to bf16, so they may differ by one bf16 step of
# the output (at most 2^-7 of it), plus fp32 rounding, far under 1e-3 of the
# row's rms.  (With randn inputs the softmax is nearly flat and |out| is
# about sqrt(e / length), so an absolute 2e-2 would pass a kernel of zeros.)
DECODE_TOL = {"float32": 2e-5, "bfloat16": "2^-7*|want|+1e-3*rms(row)"}

# the LM serving path at full width and depth, bf16 weights from a seeded
# generator: arch -> (requests, new tokens a request), through
# DecodeServer(slots=LM_SLOTS, max_len=LM_MAX_LEN); prompts cut from
# lm_batch at lengths LM_PROMPT_LENS[0]..LM_PROMPT_LENS[1]
LM_SERVED = {"llama3-8b": (16, 32), "deepseek-v2-lite-16b": (8, 16)}
LM_SLOTS, LM_MAX_LEN, LM_PROMPT_LENS = 8, 256, (16, 128)
LM_CHECKED = 2                 # requests held, step by step, to a prefill
LM_CONFIG_OVERRIDES = {}       # arch -> config fields (none: full size)
# decode against a fresh prefill, bf16 weights, max |diff| over the
# logits' max |logit|, every step: the two paths round their bf16 products
# differently (batch 8 against 1, an fp32 cache against bf16 keys), and a
# MoE token whose router input moves by that may change experts.  At
# reduced width on the CPU, 16 layers gave at most 0.017 (llama) and 0.090
# (deepseek); decode with interleaved-pair RoPE gave at least 0.60.
LM_DECODE_TOL = 0.25
# the card against the port on the CPU: the same fp32 weights at full
# width, LM_CPU_LAYERS layers (deepseek: one dense, one MoE), two requests
# of LM_CPU_NEW tokens; greedy tokens identical, logits within this share
# of their max |logit| (fp32 sums in another order)
LM_CPU_LAYERS, LM_CPU_NEW, LM_CPU_TOL = 2, 6, 1e-4

# the seed's side models at their published widths (phase side), fp32
# weights from a seeded generator.  Recommenders at RECSYS_SHAPES' serving
# cells: the sequential models score SIDE_CANDIDATES candidates a sequence
# at serve_p99 and serve_bulk (the reference's cells, launch/cells.py) and
# one sequence against RETRIEVAL_CAND candidates at retrieval_cand.
SIDE_RECSYS = ("deepfm", "sasrec", "bert4rec")
SIDE_CONFIG_OVERRIDES = {}     # arch -> config fields (none: full size)
SIDE_CANDIDATES = 100
SIDE_P99_BATCHES = 20
# serve_bulk rows a call.  bert4rec's attention scores over all 262,144
# sequences would be 262,144 x 2 heads x 200^2 x 4 B = 84 GB and its FFN
# activation 54 GB, more than the card holds, so it is served in slices
# of 32,768 sequences (about 25 GB of transients each); the width is
# unchanged.  The others take the whole batch in one call.
SIDE_BULK_SLICE = {"bert4rec": 32_768}
N_SIDE_CHECKED = 64            # rows of each cell held against float64
# gin-tu at GNN_SHAPES' cells; GNN_CELL_OVERRIDES cuts a cell's dims
# (none: full size).  Timed calls a cell.
GNN_CELL_OVERRIDES = {}
GNN_CALLS = {"ogb_products": 3, "minibatch_lg": 10, "molecule": 20,
             "full_graph_sm": 20}
# fp32 GIN logits against a float64 numpy forward (full_graph_sm and
# molecule), and the layer-1 aggregate of ogb_products nodes against
# float64 sums over the CSR: the same arithmetic in another order
GIN_F64_RTOL, GIN_F64_ATOL = 1e-4, 1e-4
AGG_RTOL, AGG_ATOL = 1e-5, 1e-4
# the card against the port on the CPU at the reference's reduced_config
# size (launch/train.py): rows a field and items 1,000, sequences of at
# most 16; gin-tu as published.  fp32 sums in another order (GIN's
# scatter-add by atomics on the card): outputs within this rtol and atol;
# accuracies may differ by one flipped argmax
SIDE_REDUCED = dict(vocab_per_field=1000, n_items=1000)
SIDE_CPU_TOL = 1e-4

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


def serving(fn):
    """A phase that serves: it runs without an autograd graph, as the
    port's served entry points do (the model weights are trainable)."""
    import functools

    @functools.wraps(fn)
    def run(*args, **kwargs):
        import torch
        with torch.no_grad():
            return fn(*args, **kwargs)

    return run


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


def _timed_call(fn):
    """``fn()`` and its host time (ms), from a synchronized card to the
    end of its work on it."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def call_us(fn, reps: int = 200) -> float:
    """Wall time of one call of ``fn`` (us) over ``reps`` calls back to
    back, after one warm-up, the card synchronized before and after: for
    a few small kernels, which the card runs faster than the host
    launches them, the host's cost a call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e6 / reps


def oracle_edges(hidx, seeds, depth, topk, beam):
    from repro_torch.core import bfs_construct_host_fast
    out = {}
    for s, d, w in bfs_construct_host_fast(hidx, seeds, depth=depth,
                                           topk=topk, beam=beam):
        key = (min(s, d), max(s, d))
        out[key] = max(out.get(key, 0), w)
    return out


def oracle_row(hidx, t, k):
    """Term ``t``'s top-``k`` neighbors by exact co-occurrence count, ties
    to the lower id, zero counts dropped: [(neighbor, count), ...]."""
    from repro_torch.core.cooccurrence import _gather_counts
    counts = _gather_counts(hidx, hidx.postings[t]).astype(np.int64)
    counts[t] = -1
    top = np.argsort(-counts, kind="stable")[:k]
    return [(int(j), int(counts[j])) for j in top if counts[j] > 0]


def network_row(net, t, k):
    """Row ``t`` of a materialized network: [(neighbor, weight), ...]."""
    sl = slice(t * k, (t + 1) * k)
    ok = net.valid[sl].cpu().numpy()
    return [(int(d), int(w)) for d, w, o in
            zip(net.dst[sl].cpu().numpy(), net.weight[sl].cpu().numpy(), ok)
            if o]


def staged_unions(pidx, step: int):
    """The size of each row group's union in the staged "pallas" sweep
    over ``pidx``: the documents holding one of the group's ``step``
    terms (empty groups past the last non-empty one left out)."""
    import torch
    from repro_torch.core.inverted_index import forward_index
    fwd = forward_index(pidx)
    cap = fwd.ptr.numel() - 1
    doc = torch.repeat_interleave(torch.arange(cap, device=fwd.ptr.device),
                                  fwd.ptr.diff())
    pairs = torch.unique(fwd.terms.to(torch.int64) // step * cap + doc)
    return torch.bincount(pairs // cap)


def staged_launches(pidx, step: int) -> int:
    """Kernel 3 launches of the staged "pallas" sweep over ``pidx``: one a
    chunk of ``DOC_CHUNK`` documents of each row group's union, none for
    an empty group."""
    from repro_torch.core.materialize import DOC_CHUNK
    return int((-(-staged_unions(pidx, step) // DOC_CHUNK)).sum())


def same_network(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


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
    regs = {name: [ln.split("info    : ")[-1].strip()
                   for ln in log.splitlines()
                   if "registers" in ln or "spill stores" in ln]
            for name, log in logs.items()}
    say("device", kind=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, build_s=f"{secs:.2f}",
        ptxas=json.dumps(regs))
    return card


@serving
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
    # the whole network: each term's top 4 by exact count, lower id on ties
    want_full = {}
    for t in range(len(lex)):
        for j, c in oracle_row(hidx, t, 4):
            key = (lex.id_to_term[min(t, j)], lex.id_to_term[max(t, j)])
            want_full[key] = c
    nodes = {term for key in want_full for term in key}
    ops.reset_launches()
    for method in ("gemm", "popcount", "pallas", "fused"):
        idx = CoocIndex.from_texts(QUICKSTART, device=dev, depth=2, topk=6,
                                   beam=8, q_batch=4, method=method)
        edges = idx.network(["networks"])
        if edges != want:
            raise AssertionError(f"quickstart network ({method}) != oracle")
        if idx.full_network(k=4) != want_full:
            raise AssertionError(f"quickstart full network ({method}) != "
                                 "oracle")
        stats = idx.network_stats(k=4)
        if (stats.n_edges, stats.n_nodes, stats.total_weight) != (
                len(want_full), len(nodes), sum(want_full.values())):
            raise AssertionError(f"quickstart network stats ({method}) != "
                                 f"oracle: {stats[:8]}")
        idx.add_documents(["inverted index networks accelerate retrieval"] * 2)
        grown = idx.network(["accelerate"], depth=1)
        if grown.get(("networks", "accelerate")) != 2:
            raise AssertionError(f"ingest not visible ({method}): {grown}")
    launches = {name: ops.LAUNCHES[name] for name in
                ("postings_counts", "level_step", "cooccur_counts")}
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")
    say("strings", methods=4, edges=len(want), full_edges=len(want_full),
        oracle=True, ingest_visible=True, launches=json.dumps(launches))
    _strings_snapshot(dev)
    _strings_mesh(dev, want, want_full)


def _same_stats(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def _strings_snapshot(dev):
    """The quickstart index saved and loaded back on the card answers like
    the live one; its approx network equals the CPU's (plain versions);
    the port's snapshot reads back with every blob's sha256 checked."""
    import hashlib
    import os
    import shutil
    import tempfile
    from repro_torch.api import CoocIndex
    from repro_torch.core import read_snapshot
    from repro_torch.kernels import ops

    plan = dict(depth=2, topk=6, beam=8, q_batch=4)
    idx = CoocIndex.from_texts(QUICKSTART, device=dev, **plan)
    cpu = CoocIndex.from_texts(QUICKSTART, device="cpu", **plan)
    tmp = tempfile.mkdtemp(prefix="cooc-strings-")
    try:
        final = idx.save(os.path.join(tmp, "snap"))
        loaded = CoocIndex.load(os.path.join(tmp, "snap"), device=dev)
        approx_launches = 0
        for method in ("gemm", "popcount", "pallas", "fused"):
            if (loaded.network(["networks"], method=method)
                    != idx.network(["networks"], method=method)):
                raise AssertionError(f"loaded quickstart query ({method}) "
                                     "!= live")
            if (loaded.full_network(k=4, method=method)
                    != idx.full_network(k=4, method=method)):
                raise AssertionError(f"loaded quickstart network ({method}) "
                                     "!= live")
            if not _same_stats(loaded.network_stats(k=4, method=method),
                               idx.network_stats(k=4, method=method)):
                raise AssertionError(f"loaded quickstart stats ({method}) "
                                     "!= live")
            before = ops.LAUNCHES["postings_counts"]
            approx = idx.full_network(k=4, method=method, mode="approx")
            approx_launches += ops.LAUNCHES["postings_counts"] - before
            if approx != cpu.full_network(k=4, method=method, mode="approx"):
                raise AssertionError(f"quickstart approx network ({method})"
                                     " != the CPU's")
        if approx_launches == 0:
            raise AssertionError("the approx quickstart launched no kernel 1")
        arrays, _ = read_snapshot(os.path.join(tmp, "snap"), verify=True)
        with open(os.path.join(final, "manifest.json")) as f:
            blobs = json.load(f)["blobs"]
        for name, blob in blobs.items():
            with open(os.path.join(final, blob["file"]), "rb") as f:
                if hashlib.sha256(f.read()).hexdigest() != blob["sha256"]:
                    raise AssertionError(f"blob {name} != its manifest sha")
        say("strings", snapshot_blobs=len(arrays), loaded_equal=True,
            approx_equal_cpu=True, sha256_checked=len(blobs),
            approx_launches=approx_launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _strings_mesh(dev, want, want_full):
    """The quickstart corpus on a mesh of MESH_SHARDS shards of the one
    card, both shard kinds: every method's query and whole network (both
    shard strategies) == the host oracle; the index saved there and
    restored onto the mesh (``CoocIndex.load``) answers alike, and the
    server warm-started onto the mesh (``CoocServer.from_snapshot``)
    serves 8 requests == a direct engine over an unsharded restore;
    ``CoocIndex(devices=1)`` is a one-shard mesh."""
    import asyncio
    import os
    import shutil
    import tempfile
    from repro_torch.api import CoocIndex
    from repro_torch.core import make_cooc_mesh
    from repro_torch.kernels import ops

    plan = dict(depth=2, topk=6, beam=8, q_batch=4)
    tmp = tempfile.mkdtemp(prefix="cooc-mesh-")
    served = 0
    ops.reset_launches()
    try:
        for shard in ("terms", "docs"):
            mesh = make_cooc_mesh(devices=[dev] * MESH_SHARDS, shard=shard)
            idx = CoocIndex.from_texts(QUICKSTART, device=dev, mesh=mesh,
                                       **plan)
            path = os.path.join(tmp, shard)
            idx.save(path)
            loaded = CoocIndex.load(path, device=dev, mesh=mesh)
            for method in ("gemm", "popcount", "pallas", "fused"):
                for which, i in (("live", idx), ("loaded", loaded)):
                    if i.network(["networks"], method=method) != want:
                        raise AssertionError(f"quickstart on a {shard} mesh "
                                             f"({which}, {method}) != oracle")
                    for strategy in ("rows", "cols"):
                        if i.full_network(k=4, method=method,
                                          shard_strategy=strategy) \
                                != want_full:
                            raise AssertionError(
                                f"quickstart network on a {shard} mesh "
                                f"({which}, {method}, {strategy}) != oracle")
            served += asyncio.run(_strings_served(dev, path, mesh))
        one = CoocIndex.from_texts(
            QUICKSTART, device=dev, **plan,
            devices=1 if dev.type == "cuda" else [dev])
        if one.mesh is None or one.mesh.size != 1 \
                or one.network(["networks"]) != want:
            raise AssertionError("CoocIndex(devices=1) is not a one-shard "
                                 "mesh answering like the oracle")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {name: ops.LAUNCHES[name] for name in
                ("postings_counts", "level_step", "cooccur_counts")}
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched on a mesh: "
                             f"{launches}")
    say("strings", mesh_shards=MESH_SHARDS, mesh_kinds="terms,docs",
        mesh_oracle=True, mesh_loaded_equal=True, mesh_served_equal=served,
        one_shard_mesh=True, mesh_launches=json.dumps(launches))


async def _strings_served(dev, path, mesh):
    """8 requests through a server warm-started onto ``mesh`` == a direct
    engine over the same snapshot restored on one device."""
    from repro_torch.core import load_context
    from repro_torch.serve import CoocEngine, CoocServer, TenantConfig
    srv = CoocServer.from_snapshot(path, tenants=[TenantConfig("t")],
                                   device=dev, mesh=mesh)
    if srv.ctx.mesh != mesh:
        raise AssertionError("the warm start dropped the mesh")
    eng = CoocEngine(load_context(path, device=dev), device=dev, q_batch=4)
    plan = dict(depth=2, topk=6, beam=8)
    await srv.start()
    try:
        for i in range(8):
            method = ("fused", "pallas")[i % 2]
            r = await srv.submit("t", dict(seeds=[i], method=method, **plan),
                                 deadline_ms=600_000.0)
            want = eng.submit([i], method=method, **plan).result().network
            if not (r.ok and all(np.array_equal(np.asarray(a), np.asarray(b))
                                 for a, b in zip(r.result.network, want))):
                raise AssertionError(f"meshed server request {i} ({method}) "
                                     f"!= a direct engine: {r}")
    finally:
        await srv.stop()
    return 8


@serving
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
    return ctx, hidx, seeds, launches


@serving
def phase_materialize(dev, ctx, hidx, launches):
    """The whole CSL network at full width: top-16 for each of the 65,536
    terms over all 396,209 docs, through the kernel (GROUP 128-term row
    blocks a group, one launch a chunk of each group's documents, each on
    the TMA path) and through
    ``torch._int_mm`` (method "gemm", one call per row block)."""
    import torch
    from repro_torch.core import global_statistics, materialize
    from repro_torch.core.materialize import GROUP
    from repro_torch.kernels import ops

    v = ctx.vocab_size
    t0 = time.perf_counter()
    xd = ctx.x_dense()
    torch.cuda.synchronize()
    say("materialize", x_dense_s=f"{time.perf_counter() - t0:.3f}",
        x_dense_gb=f"{xd.numel() / 1e9:.3f}", x_dense_shape=tuple(xd.shape),
        x_dense_strides=xd.stride(), unpack_count=ctx.unpack_count)

    n_blocks = -(-v // ROW_TILE)
    n_launch = staged_launches(ctx.index, GROUP * ROW_TILE)
    # one top-k a row group with documents ("pallas"), a row block ("gemm")
    n_topk = {"pallas": int((staged_unions(ctx.index, GROUP * ROW_TILE)
                             > 0).sum()), "gemm": n_blocks}
    nets, secs = {}, {}
    for method in ("pallas", "gemm"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        nets[method] = materialize(ctx, k=MAT_K, method=method,
                                   row_tile=ROW_TILE, use_cache=False)
        torch.cuda.synchronize()
        secs[method] = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        paths = dict(ops.COOCCUR_PATHS)
        extra_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        if method == "pallas":
            if not counts["cooccur_counts"] == paths["tma"] == n_launch:
                raise AssertionError(f"{counts['cooccur_counts']} cooccur "
                                     f"launches ({paths}) for {n_launch} "
                                     f"chunks of groups of {GROUP} row "
                                     "blocks")
            launches["cooccur_counts"] = counts["cooccur_counts"]
            launches["row_topk"] = counts["row_topk"]
        if counts["row_topk"] != n_topk[method]:
            raise AssertionError(f"{counts['row_topk']} row top-k launches "
                                 f"for {n_topk[method]} row sets of "
                                 f"method {method}")
        if extra_gb > xd.numel() / 2e9:
            # a copy of the 26 GB operand would show here
            raise AssertionError(f"method {method} took {extra_gb:.1f} GB "
                                 "beyond the resident artifacts")
        say("materialize", method=method, k=MAT_K, row_blocks=n_blocks,
            group=GROUP if method == "pallas" else 1,
            seconds=f"{secs[method]:.3f}",
            rows_per_s=f"{v / secs[method]:.1f}",
            launches=json.dumps(counts), cooccur_paths=json.dumps(paths),
            transient_gb=f"{extra_gb:.3f}")
    if not same_network(nets["pallas"], nets["gemm"]):
        raise AssertionError("CSL materialize: pallas != gemm")

    df = ctx.index.doc_freq.cpu().numpy()
    rng = np.random.default_rng(1)
    head = rng.choice(np.argsort(-df, kind="stable")[:256],
                      N_ROWS_CHECKED // 2, replace=False)
    tail_pool = np.flatnonzero((df >= 1) & (df <= 64))
    tail = rng.choice(tail_pool, min(N_ROWS_CHECKED // 2, len(tail_pool)),
                      replace=False)
    t0 = time.perf_counter()
    for t in [int(x) for x in np.concatenate([head, tail])]:
        if network_row(nets["pallas"], t, MAT_K) != oracle_row(hidx, t,
                                                               MAT_K):
            raise AssertionError(f"CSL materialized row {t} != host oracle")
    oracle_s = time.perf_counter() - t0
    stats = global_statistics(nets["pallas"], v)
    say("materialize", identical=True, rows_checked=len(head) + len(tail),
        oracle_s=f"{oracle_s:.2f}", nodes=stats.n_nodes,
        edges=stats.n_edges, density=f"{stats.density:.6g}",
        max_degree=stats.max_degree, max_weight=stats.max_weight,
        max_memory_allocated_gb=
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    return nets["pallas"], secs["pallas"]


def _timed(module, name, secs, outs=None):
    """Wrap ``module.name`` so that each call adds its host seconds (after a
    synchronize) to ``secs[name]`` (and leaves its result in
    ``outs[name]``); returns the undo."""
    import torch
    fn = getattr(module, name)

    def timed(*args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t
        if outs is not None:
            outs[name] = out
        return out

    setattr(module, name, timed)
    return lambda: setattr(module, name, fn)


def _same_approx(a, b):
    return (same_network(a[:4], b[:4]) and a.recall_estimate
            == b.recall_estimate and a.stats == b.stats)


def _check_approx_weights(net, exact, hidx, k):
    """Every valid approx edge's weight is its pair's count: read from
    the exact network where the pair is among the row's top ``k``, else
    from the host oracle's postings.  Returns (edges, from the oracle)."""
    ok = net.valid.cpu().numpy()
    src = net.src.cpu().numpy()[ok]
    dst = net.dst.cpu().numpy()[ok]
    w = net.weight.cpu().numpy()[ok]
    ex_dst = exact.dst.cpu().numpy().reshape(-1, k)[src]
    ex_w = exact.weight.cpu().numpy().reshape(-1, k)[src]
    hit = ex_dst == dst[:, None]
    found = hit.any(axis=1)
    if not (ex_w[hit] == w[found]).all():
        raise AssertionError("an approx weight != the exact network's")
    for a, b, wt in zip(src[~found], dst[~found], w[~found]):
        n = len(np.intersect1d(hidx.postings[a], hidx.postings[b],
                               assume_unique=True))
        if n != wt:
            raise AssertionError(f"approx edge ({a}, {b}) weight {wt} != "
                                 f"its count {n}")
    return len(w), int((~found).sum())


def _approx_tile_kernel(ctx, per_block):
    """Kernel 1 on the sweep's widest candidate tile, built as the sweep
    builds it: == its plain version, and timed beside it and its bound."""
    import torch
    from repro_torch.core import sketch
    from repro_torch.kernels import ops, ref
    v, w = ctx.vocab_size, ctx.index.n_words
    bi = max((i for i, c in enumerate(per_block) if c is not None),
             key=lambda i: len(per_block[i]))
    cand = torch.from_numpy(sketch.pad_candidates(per_block[bi], v)).to(
        ctx.device)
    masks = ctx.packed_t_pad()[bi * ROW_TILE:(bi + 1) * ROW_TILE, :w]
    masks = masks.contiguous()
    sub = ctx.index.packed.index_select(1, cand.clamp(min=0))
    sub[:, cand < 0] = 0
    got = ops.postings_counts(masks, sub)
    want, plain_ms = _event_ms(lambda: ref.postings_counts_ref(masks, sub))
    if not torch.equal(got, want):
        raise AssertionError("postings kernel != plain on the widest CSL "
                             "approx tile")
    ms = cuda_ms(lambda: ops.postings_counts(masks, sub), 20)
    nz = masks != 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    c = sub.shape[1]
    bound_ms, bound_by, n_ops, n_bytes = _bound(
        int(nz.sum()), int(nz.any(dim=0).sum()), masks.shape[0] * c * 4,
        masks.numel() * 4, c, sms, hz)
    say("approx", kernel="postings_counts", row_block=bi, rows=ROW_TILE,
        words=w, columns=c, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, popcounts=n_ops,
        bytes=n_bytes, max_abs_err=0)


@serving
def phase_approx(dev, ctx, hidx, exact, exact_s):
    """The approximate sweep at the CSL scale, k = 16 at the defaults:
    MinHash signatures of every term (128 permutations), LSH banding on
    the host, and each row block counted against its candidate columns
    through kernel 1 ("pallas") and through ``torch._int_mm`` ("gemm")."""
    import importlib
    import torch
    from repro_torch.core import materialize, sketch
    from repro_torch.kernels import ops
    mat = importlib.import_module("repro_torch.core.materialize")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sigs = ctx.term_signatures(num_perm=sketch.DEFAULT_NUM_PERM)
    torch.cuda.synchronize()
    sig_s = time.perf_counter() - t0
    nets, secs, outs = {}, {}, {}
    for method in ("pallas", "gemm"):
        parts = {}
        undo = [_timed(mat, name, parts, outs)
                for name in ("candidate_columns", "_approx_sweep")]
        ops.reset_launches()
        t0 = time.perf_counter()
        try:
            nets[method] = materialize(ctx, k=MAT_K, mode="approx",
                                       method=method, row_tile=ROW_TILE,
                                       use_cache=False)
            torch.cuda.synchronize()
        finally:
            for fn in undo:
                fn()
        secs[method] = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        st = nets[method].stats
        if method == "pallas" and counts["postings_counts"] == 0:
            raise AssertionError("the approx sweep never launched kernel 1")
        say("approx", method=method, k=MAT_K, seconds=f"{secs[method]:.3f}",
            band_s=f"{parts['candidate_columns']:.3f}",
            count_s=f"{parts['_approx_sweep']:.3f}",
            tiles_counted=st.tiles_counted, tiles_total=st.tiles_total,
            tiles_fraction=f"{st.tiles_fraction:.6f}",
            candidate_pairs=st.candidate_pairs, bands=st.bands,
            rows_per_band=st.rows_per_band,
            launches=json.dumps(counts))
    if not _same_approx(nets["pallas"], nets["gemm"]):
        raise AssertionError("CSL approx: pallas != gemm")
    _approx_tile_kernel(ctx, outs["candidate_columns"][0])
    net = nets["pallas"]
    t0 = time.perf_counter()
    edges, from_oracle = _check_approx_weights(net, exact, hidx, MAT_K)
    weights_s = time.perf_counter() - t0
    # signatures of sampled terms against numpy: docs are slots here
    a, b = sketch.hash_coefficients(sketch.DEFAULT_NUM_PERM)
    df = ctx.index.doc_freq.cpu().numpy()
    rng = np.random.default_rng(3)
    terms = np.concatenate([
        rng.choice(np.flatnonzero(df > 0), N_SIGS_CHECKED - 1,
                   replace=False), np.flatnonzero(df == 0)[:1]])
    got = sigs[torch.from_numpy(terms).to(ctx.device)].cpu().numpy().view(
        np.uint32)
    for t, row in zip(terms, got):
        d = hidx.postings[t].astype(np.uint64)
        want = np.full(len(a), sketch.SIG_EMPTY, np.uint64)
        if len(d):
            want = ((a.astype(np.uint64)[:, None] * d[None, :]
                     + b[:, None]) & 0xFFFFFFFF).min(axis=1)
        if not np.array_equal(row.astype(np.uint64), want):
            raise AssertionError(f"CSL signature of term {t} != numpy")
    say("approx", identical=True, sig_s=f"{sig_s:.3f}",
        signatures_checked=len(terms), edges=edges,
        edges_from_exact=edges - from_oracle,
        edges_from_oracle=from_oracle, weights_s=f"{weights_s:.2f}",
        recall_estimate=f"{net.recall_estimate:.6f}",
        approx_s=f"{secs['pallas']:.3f}", exact_s=f"{exact_s:.3f}",
        max_memory_allocated_gb=
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    return net, secs["pallas"], sig_s


def _host_slots(net):
    """A network's four slot arrays, stacked on the host."""
    return np.stack([np.asarray(a.cpu() if hasattr(a, "cpu") else a)
                     .astype(np.int64) for a in net[:4]])


def _mesh_queries(ctx, seeds, method):
    """The CSL queries through a CoocEngine over ``ctx`` (one warm-up
    query first): their networks stacked on the host, each batch's ms,
    the seconds, and the launches of the run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import CoocEngine
    eng = CoocEngine(ctx, device=ctx.device, depth=DEPTH, topk=TOPK,
                     beam=BEAM, q_batch=Q_BATCH, method=method)
    eng.query([seeds[0]])
    torch.cuda.synchronize()
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
    nets = np.stack([_host_slots(f.result().network) for f in futs])
    for s in seeds[:Q_BATCH]:          # one more full batch, left queued
        eng.submit([s])
    return nets, batch_ms, secs, counts, eng


@serving
def phase_mesh(dev, ctx, seeds, exact, exact_s, approx, approx_s,
               sig_s_unsharded):
    """The CSL index of phase csl on a mesh of MESH_SHARDS shards of the
    one card, each answer held equal to the unsharded one of this run.
    Term mesh: the 64 queries under "fused" (kernel 2 once a level per
    shard) and "pallas" (kernel 1 per shard), the whole network under
    "pallas" with shard_strategy "rows" and "cols" (kernel 3 per shard
    or per row-block range), the approx network (kernel 1 per shard on
    each candidate tile) and the MinHash signatures.  Doc mesh: the 64
    queries under both methods (kernel 1 per shard) and the whole network
    doc-split ("cols": kernel 3 per doc shard, partial counts summed).
    The unsharded answers are kept on the host and the unsharded
    context's dense artifacts dropped first, so the peak stays near
    phase csl's.  Returns the launches of each kernel in the phase."""
    import torch
    from repro_torch.core import QueryContext, make_cooc_mesh, materialize
    from repro_torch.core.distributed import shard_ranges
    from repro_torch.core.materialize import GROUP
    from repro_torch.core.sketch import DEFAULT_NUM_PERM
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    n = MESH_SHARDS
    v = ctx.vocab_size
    total = {"postings_counts": 0, "level_step": 0, "cooccur_counts": 0}
    counters = {"fused": "level_step", "pallas": "postings_counts"}
    want, base = {}, {}
    for method in counters:
        nets, ms, secs, _, eng = _mesh_queries(ctx, seeds, method)
        want[method], base[method] = nets, (ms, secs)
        say_profile("mesh", f"none_{method}_batch", eng.step)
    want_net = _host_slots(exact)
    want_approx = (_host_slots(approx), approx.stats, approx.recall_estimate)
    want_sig = ctx.term_signatures(num_perm=DEFAULT_NUM_PERM).cpu()
    ctx._cache.clear()                 # x_dense, packed_t_pad: about 29 GB
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def queries(mctx, kind, method, counter):
        nets, ms, secs, counts, eng = _mesh_queries(mctx, seeds, method)
        if not np.array_equal(nets, want[method]):
            raise AssertionError(f"{kind} mesh queries ({method}) != "
                                 "unsharded")
        if counts[counter] != len(ms) * DEPTH * filled(mctx):
            raise AssertionError(f"{kind} mesh {method}: {counts[counter]} "
                                 f"{counter} launches, not {DEPTH} a level "
                                 f"per shard over {len(ms)} batches")
        for name in total:
            total[name] += counts[name]
        b_ms, b_secs = base[method]
        say("mesh", mesh=kind, shards=n, method=method,
            queries=len(seeds), batches=len(ms),
            batch_p50_ms=f"{np.percentile(ms, 50):.3f}",
            unsharded_batch_p50_ms=f"{np.percentile(b_ms, 50):.3f}",
            qps=f"{len(seeds) / secs:.3f}",
            unsharded_qps=f"{len(seeds) / b_secs:.3f}",
            launches_per_batch_per_shard=f"{counts[counter] / len(ms) / n:.2f}",
            launches=json.dumps(counts), identical=True)
        say_profile("mesh", f"{kind}_{method}_batch", eng.step)

    def sweep(mctx, kind, strategy, launches_want):
        ops.reset_launches()
        t0 = time.perf_counter()
        net = materialize(mctx, k=MAT_K, method="pallas", row_tile=ROW_TILE,
                          shard_strategy=strategy, use_cache=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, paths = dict(ops.LAUNCHES), dict(ops.COOCCUR_PATHS)
        if not np.array_equal(_host_slots(net), want_net):
            raise AssertionError(f"{kind} mesh network ({strategy}) != "
                                 "unsharded")
        if not counts["cooccur_counts"] == paths["tma"] == launches_want:
            raise AssertionError(f"{kind} mesh {strategy}: "
                                 f"{counts['cooccur_counts']} cooccur "
                                 f"launches ({paths}), not {launches_want} "
                                 "on the TMA path")
        for name in total:
            total[name] += counts[name]
        say("mesh", mesh=kind, shards=n, strategy=strategy, method="pallas",
            k=MAT_K, seconds=f"{secs:.3f}", unsharded_seconds=f"{exact_s:.3f}",
            launches=json.dumps(counts), cooccur_paths=json.dumps(paths),
            identical=True)

    def filled(mctx):                  # shards holding any column / word
        return sum(s.hi > s.lo for s in mctx.mesh_shards().shards)

    # launches: "cols" one a row-block group per filled shard, "rows" one
    # a group of each shard's contiguous range of row blocks
    n_groups = -(-v // (GROUP * ROW_TILE))
    rows_launches = sum(
        len(range(b0 * ROW_TILE, b1 * ROW_TILE, GROUP * ROW_TILE))
        for b0, b1 in shard_ranges(-(-v // ROW_TILE), n))

    # term mesh
    mctx = QueryContext(ctx.index, device=dev,
                        mesh=make_cooc_mesh(devices=[dev] * n))
    t0 = time.perf_counter()
    shards = mctx.mesh_shards()
    torch.cuda.synchronize()
    say("mesh", mesh="terms", shards=n, shard_columns=json.dumps(
        [s.hi - s.lo for s in shards.shards]),
        shard_build_s=f"{time.perf_counter() - t0:.3f}")
    for method, counter in counters.items():
        queries(mctx, "terms", method, counter)
    mctx.x_dense()
    sweep(mctx, "terms", "rows", rows_launches)
    sweep(mctx, "terms", "cols", filled(mctx) * n_groups)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sig = mctx.term_signatures(num_perm=DEFAULT_NUM_PERM)
    torch.cuda.synchronize()
    sig_s = time.perf_counter() - t0
    if not torch.equal(sig.cpu(), want_sig):
        raise AssertionError("term mesh signatures != unsharded")
    ops.reset_launches()
    t0 = time.perf_counter()
    got = materialize(mctx, k=MAT_K, mode="approx", method="pallas",
                      row_tile=ROW_TILE, use_cache=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    if not (np.array_equal(_host_slots(got), want_approx[0])
            and got.stats == want_approx[1]
            and got.recall_estimate == want_approx[2]):
        raise AssertionError("term mesh approx network != unsharded")
    if counts["postings_counts"] == 0 \
            or counts["postings_counts"] % filled(mctx):
        raise AssertionError(f"term mesh approx: {counts} launches")
    for name in total:
        total[name] += counts[name]
    say("mesh", mesh="terms", shards=n, mode="approx", method="pallas",
        seconds=f"{secs:.3f}", unsharded_seconds=f"{approx_s:.3f}",
        sig_s=f"{sig_s:.3f}", unsharded_sig_s=f"{sig_s_unsharded:.3f}",
        launches=json.dumps(counts),
        tiles_counted=got.stats.tiles_counted, identical=True,
        signatures_identical=True)
    del mctx, shards, got, sig
    torch.cuda.empty_cache()

    # doc mesh
    dctx = QueryContext(ctx.index, device=dev,
                        mesh=make_cooc_mesh(devices=[dev] * n, shard="docs"))
    say("mesh", mesh="docs", shards=n, shard_words=json.dumps(
        [s.hi - s.lo for s in dctx.mesh_shards().shards]))
    for method in counters:
        queries(dctx, "docs", method, "postings_counts")
    dctx.x_dense()
    sweep(dctx, "docs", "cols", filled(dctx) * n_groups)
    del dctx
    torch.cuda.empty_cache()
    say("mesh", seconds=f"{time.perf_counter() - t_phase:.1f}",
        launches=json.dumps(total), max_memory_allocated_gb=
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    return total


def _pad_block(docs, max_len=64):
    """(N, max_len) int32 term ids, -1 padded, and an all-true valid row."""
    import torch
    ids = np.full((len(docs), max_len), -1, np.int32)
    for i, d in enumerate(docs):
        ids[i, :len(d)] = d
    return torch.from_numpy(ids), torch.ones((len(docs),), dtype=torch.bool)


def _live_host_index(hidx, lo):
    """The host index of docs ``lo..`` of ``hidx``, renumbered from 0."""
    from repro_torch.core import HostIndex
    base = hidx.fwd_ptr[lo]
    return HostIndex([p[p >= lo] - lo for p in hidx.postings],
                     hidx.fwd_terms[base:], hidx.fwd_ptr[lo:] - base,
                     hidx.vocab_size)


def _oracle_batch(eng, want, v, what):
    """Serve the seeds of ``want`` (seed -> oracle edges) through ``eng``
    and hold each answer against its oracle."""
    futs = {s: eng.submit([s]) for s in want}
    eng.run_until_drained()
    for s, f in futs.items():
        res = f.result()
        check_network(res, v)
        if res.edges() != want[s]:
            raise AssertionError(f"stream {what} != host oracle, seed {s}")


@serving
def phase_stream(dev):
    """The streaming tier at the stream_ingest cell, through kernels 1, 2
    and 3: a window ring of CSL docs, evicting rounds that spill to a cold
    store, and the all-time network over the live and cold tiers."""
    import torch
    from repro_torch.core import (QueryContext, build_host_index,
                                  decode_block, encode_block, materialize)
    from repro_torch.core.materialize import GROUP
    from repro_torch.data import synthetic_csl
    from repro_torch.kernels import ops
    from repro_torch.serve import CoocEngine

    t_phase = time.perf_counter()
    v = CSL_TERMS
    docs = synthetic_csl(STREAM_WINDOW, v, seed=0)
    stream = synthetic_csl(STREAM_ROUNDS * STREAM_BLOCK, v, seed=1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx = QueryContext.from_docs([], v, device=dev, window=STREAM_WINDOW,
                                 cold_store={})
    cap, shape = ctx.index.capacity, tuple(ctx.index.packed.shape)
    for lo in range(0, STREAM_WINDOW, STREAM_BLOCK):
        ctx.ingest(*_pad_block(docs[lo:lo + STREAM_BLOCK]))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    if (ctx.live_docs, ctx.evicted_docs_total) != (STREAM_WINDOW, 0):
        raise AssertionError(f"fill gave {ctx.live_docs} live docs, "
                             f"{ctx.evicted_docs_total} evicted")
    clone_ms = cuda_ms(lambda: ctx.index.packed.clone(), 5)
    say("stream", window=STREAM_WINDOW, capacity=cap, words=shape[0],
        terms=v, fill_ingests=ctx.n_blocks, fill_s=f"{fill_s:.2f}",
        packed_gb=f"{ctx.index.packed.numel() * 4 / 1e9:.3f}",
        packed_clone_ms=f"{clone_ms:.4f}")

    # four head and four tail seeds of the filled window
    df = ctx.index.doc_freq.cpu().numpy()
    rng = np.random.default_rng(2)
    seeds = [int(x) for x in np.concatenate([
        rng.choice(np.argsort(-df, kind="stable")[:256], N_ORACLE // 2,
                   replace=False),
        rng.choice(np.flatnonzero((df >= 8) & (df <= 64)), N_ORACLE // 2,
                   replace=False)])]
    eng = CoocEngine(ctx, device=dev, depth=STREAM_DEPTH, topk=TOPK,
                     beam=BEAM, q_batch=Q_BATCH, method="fused")
    eng.query([seeds[0]])                # first use: allocator, caches
    spill_ms = []
    spill = ctx._spill_block

    def timed_spill(slots):
        t = time.perf_counter()
        spill(slots)                     # ends in the payload's copy out
        spill_ms.append((time.perf_counter() - t) * 1e3)

    ctx._spill_block = timed_spill
    blocks = [_pad_block(stream[lo:lo + STREAM_BLOCK]) for lo in
              range(0, len(stream), STREAM_BLOCK)]
    ingest_ms, batch_ms, mem = [], [], []
    ops.reset_launches()
    for r, block in enumerate(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slots = ctx.ingest(*block, scope="rounds")
        torch.cuda.synchronize()
        ingest_ms.append((time.perf_counter() - t0) * 1e3)
        futs = [eng.submit([s]) for s in seeds]
        t0 = time.perf_counter()
        eng.step()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        if not all(f.done() for f in futs):
            raise AssertionError("the post-ingest batch left queries queued")
        mem.append(torch.cuda.memory_allocated())
        if (ctx.index.capacity, tuple(ctx.index.packed.shape)) != (cap,
                                                                   shape):
            raise AssertionError(f"round {r}: the ring grew to "
                                 f"{tuple(ctx.index.packed.shape)}")
        if r == 0 and not (slots[0] == STREAM_WINDOW and slots[-1] <
                           slots[0]):
            raise AssertionError(f"round 0 wrote slots {slots[0]}.."
                                 f"{slots[-1]}, not a wrap from the top")
        say("stream", round=r, slots=f"{slots[0]}..{slots[-1]}",
            ingest_ms=f"{ingest_ms[-1]:.3f}", spill_ms=f"{spill_ms[-1]:.3f}",
            fused_batch_ms=f"{batch_ms[-1]:.3f}",
            memory_allocated_gb=f"{mem[-1] / 1e9:.3f}")
    del ctx._spill_block, spill          # both refer to ctx
    # the spill's host part: the npz encode of the last payload
    payload = decode_block(ctx.cold_store[max(ctx.cold_store)])
    t0 = time.perf_counter()
    encode_block(payload)
    encode_ms = (time.perf_counter() - t0) * 1e3
    evicted = STREAM_ROUNDS * STREAM_BLOCK
    if (ctx.live_docs, ctx.evicted_docs_total, ctx.cold_blocks()) != (
            STREAM_WINDOW, evicted, STREAM_ROUNDS):
        raise AssertionError(
            f"after the rounds: {ctx.live_docs} live, "
            f"{ctx.evicted_docs_total} evicted, {ctx.cold_blocks()} cold")
    if mem[-1] > 1.01 * mem[0]:
        raise AssertionError(f"memory grew from {mem[0]} to {mem[-1]} bytes "
                             "over the rounds")
    p = {q: np.percentile(x, [50, 99]) for q, x in
         (("ingest", ingest_ms), ("spill", spill_ms), ("batch", batch_ms))}
    say("stream", rounds=STREAM_ROUNDS, evicted=evicted,
        cold_blocks=ctx.cold_blocks(),
        ingest_p50_ms=f"{p['ingest'][0]:.3f}",
        ingest_p99_ms=f"{p['ingest'][1]:.3f}",
        spill_p50_ms=f"{p['spill'][0]:.3f}",
        spill_p99_ms=f"{p['spill'][1]:.3f}",
        payload_mb=f"{payload.packed.nbytes / 1e6:.3f}",
        encode_ms=f"{encode_ms:.3f}",
        fused_batch_p50_ms=f"{p['batch'][0]:.3f}",
        fused_batch_p99_ms=f"{p['batch'][1]:.3f}",
        memory_growth_bytes=mem[-1] - mem[0])

    # the live docs are the fill's docs from `evicted` on, then the stream
    t0 = time.perf_counter()
    every = docs + stream
    hidx = build_host_index(every, v)
    live = _live_host_index(hidx, evicted)
    want_df = np.array([len(x) for x in live.postings], np.int32)
    if not np.array_equal(ctx.index.doc_freq.cpu().numpy(), want_df):
        raise AssertionError("windowed doc_freq != the live docs' df")
    want = {s: oracle_edges(live, [s], STREAM_DEPTH, TOPK, BEAM)
            for s in seeds}
    _oracle_batch(eng, want, v, "fused")
    _oracle_batch(CoocEngine(ctx, device=dev, depth=STREAM_DEPTH, topk=TOPK,
                             beam=BEAM, q_batch=Q_BATCH, method="pallas"),
                  want, v, "pallas")
    say("stream", doc_freq_exact=True, oracle_queries=len(seeds),
        methods="fused,pallas", oracle_s=f"{time.perf_counter() - t0:.2f}")

    combined = ctx.all_time_index()
    stacked = (combined.n_words, combined.n_docs)
    n_launch = staged_launches(combined, GROUP * ROW_TILE)
    del combined
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    net_all = materialize(ctx, k=MAT_K, scope="all-time", method="pallas",
                          row_tile=ROW_TILE)
    torch.cuda.synchronize()
    all_time_s = time.perf_counter() - t0
    launches = {name: ops.LAUNCHES[name] for name in
                ("postings_counts", "level_step", "cooccur_counts")}
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")
    if launches["cooccur_counts"] != n_launch:
        raise AssertionError(f"{launches['cooccur_counts']} cooccur launches "
                             "for the all-time sweep")
    say("stream", all_time_words=stacked[0], all_time_slots=stacked[1],
        all_time_s=f"{all_time_s:.3f}",
        all_time_transient_gb=
        f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.3f}",
        launches=json.dumps(launches))

    # a "gemm" batch after an ingest rebuilds the whole dense incidence
    t0 = time.perf_counter()
    xd = ctx.x_dense()
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    gemm = CoocEngine(ctx, device=dev, depth=STREAM_DEPTH, topk=TOPK,
                      beam=BEAM, q_batch=Q_BATCH, method="gemm")
    t0 = time.perf_counter()
    _oracle_batch(gemm, want, v, "gemm")
    say("stream", gemm_x_dense_rebuild_s=f"{rebuild_s:.3f}",
        x_dense_gb=f"{xd.numel() / 1e9:.3f}",
        gemm_batch_ms=f"{(time.perf_counter() - t0) * 1e3:.3f}",
        gemm_oracle=True)
    # the ring stays for the snapshot phase; its dense artifacts go
    alive = weakref.ref(xd)
    del xd, gemm, eng, futs              # a future refers to its engine
    ctx._cache.clear()
    if alive() is not None:
        raise AssertionError("the windowed context's x_dense outlived its "
                             "last use")
    torch.cuda.empty_cache()

    # every doc ever ingested, in one append-mode context
    fresh = QueryContext.from_docs([], v, capacity=len(every), device=dev)
    fresh.ingest(*_pad_block(every))
    net_fresh = materialize(fresh, k=MAT_K, method="pallas",
                            row_tile=ROW_TILE, use_cache=False)
    if not same_network(net_all, net_fresh):
        raise AssertionError("all-time network != a fresh context's")
    rows = np.concatenate([seeds, rng.choice(v, N_ROWS_CHECKED - len(seeds),
                                             replace=False)])
    for t in [int(x) for x in rows]:
        if network_row(net_all, t, MAT_K) != oracle_row(hidx, t, MAT_K):
            raise AssertionError(f"all-time row {t} != host oracle")
    say("stream", fresh_docs=len(every), identical=True,
        rows_checked=len(rows),
        max_memory_allocated_gb=
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        seconds=f"{time.perf_counter() - t_phase:.1f}")
    return launches, {"ctx": ctx, "seeds": seeds}


def _snapshot_dir(need_bytes, prefix="cooc-snapshot-"):
    """A fresh temporary directory on a file system with room for
    ``need_bytes`` and a tenth more: the system's temporary directory, else
    the checkout's.  Raises when neither has the room."""
    import shutil
    import tempfile
    free = {}
    for base in (tempfile.gettempdir(), str(ROOT)):
        free[base] = shutil.disk_usage(base).free
        if free[base] > 1.1 * need_bytes:
            return tempfile.mkdtemp(prefix=prefix, dir=base)
    raise RuntimeError(
        f"no room for {need_bytes / 1e9:.2f} GB under {prefix}: free bytes "
        f"{free}; point TMPDIR at a larger local disk")


def _fused_edges(ctx, dev, seeds):
    from repro_torch.serve import CoocEngine
    eng = CoocEngine(ctx, device=dev, depth=STREAM_DEPTH, topk=TOPK,
                     beam=BEAM, q_batch=Q_BATCH, method="fused")
    futs = [eng.submit([s]) for s in seeds]
    eng.run_until_drained()
    return [f.result().edges() for f in futs]


def _same_state(a, b):
    """Bits, doc_freq, ring, scopes and cold payload bytes of two
    contexts; raises on the first difference."""
    import torch
    checks = {
        "packed": torch.equal(a.index.packed, b.index.packed),
        "doc_freq": torch.equal(a.index.doc_freq, b.index.doc_freq),
        "ring": (a.n_docs, a._ring_tail, a.window, a._stranded,
                 a.evicted_docs_total, a.epoch, a.n_blocks)
                == (b.n_docs, b._ring_tail, b.window, b._stranded,
                    b.evicted_docs_total, b.epoch, b.n_blocks)
                and all(np.array_equal(x, y)
                        for x, y in zip(a._blocks, b._blocks)),
        "scopes": a.scope_names() == b.scope_names() and all(
            np.array_equal(a._scope_host(n), b._scope_host(n))
            and a.scope_version(n) == b.scope_version(n)
            for n in a.scope_names()),
        "cold": (a.cold_version() == b.cold_version()
                 and sorted(a.cold_store) == sorted(b.cold_store)
                 and all(a.cold_store[key] == b.cold_store[key]
                         for key in a.cold_store)),
    }
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"restored context differs in {bad}")


@serving
def phase_snapshot(dev, state):
    """The stream phase's windowed context (97 live blocks, 8 cold blocks,
    the tag scope "rounds") sketched, its all-time approx network built,
    saved to local disk and loaded back on the card by the serve phase's
    warm start (``CoocServer.from_snapshot``); the server's context equals
    the live one, rehashes no block, serves the same answers and keeps
    streaming identically.  Returns the serve phase's state."""
    import hashlib
    import importlib
    import os
    import shutil
    import torch
    from repro_torch.core import atomic_io, materialize, save_context
    from repro_torch.data import synthetic_csl
    from repro_torch.kernels import ops
    from repro_torch.serve import CoocServer
    sk = importlib.import_module("repro_torch.core.sketch")

    t_phase = time.perf_counter()
    ctx, seeds = state.pop("ctx"), state.pop("seeds")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sig = ctx.term_signatures(num_perm=sk.DEFAULT_NUM_PERM)
    torch.cuda.synchronize()
    sig_s = time.perf_counter() - t0
    sketch_bytes = sum(e[1].numel() * 4 for ents in
                       ctx._sketch_blocks.values() for e in ents)
    ops.reset_launches()
    t0 = time.perf_counter()
    net = materialize(ctx, k=MAT_K, scope="all-time", mode="approx",
                      method="pallas", row_tile=ROW_TILE)
    torch.cuda.synchronize()
    approx_s = time.perf_counter() - t0
    if ops.LAUNCHES["postings_counts"] == 0:
        raise AssertionError("the all-time approx sweep never launched "
                             "kernel 1")
    say("snapshot", live_blocks=ctx.n_blocks, cold_blocks=ctx.cold_blocks(),
        scopes=",".join(ctx.scope_names()), sig_s=f"{sig_s:.3f}",
        sketch_gb=f"{sketch_bytes / 1e9:.3f}",
        all_time_approx_s=f"{approx_s:.3f}",
        tiles_fraction=f"{net.stats.tiles_fraction:.6f}",
        candidate_pairs=net.stats.candidate_pairs,
        launches=json.dumps(dict(ops.LAUNCHES)))

    need = (ctx.index.packed.numel() * 4 + sketch_bytes
            + sum(len(x) for x in ctx.cold_store.values()))
    tenants, gamma_docs = _serve_tenants(dev)
    tmp = _snapshot_dir(need)
    fsync = {}
    try:
        path = os.path.join(tmp, "snap")
        undo = _timed(atomic_io, "fsync_path", fsync)
        t0 = time.perf_counter()
        try:
            final = save_context(ctx, path)
        finally:
            undo()
        save_s = time.perf_counter() - t0
        gb = sum(os.path.getsize(os.path.join(final, f))
                 for f in os.listdir(final)) / 1e9
        # the serve phase's warm start is this phase's restore
        t0 = time.perf_counter()
        server = CoocServer.from_snapshot(path, tenants=tenants,
                                          config=_serve_config(), device=dev,
                                          verify=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    restored = server.ctx
    # the host's share: its sha256 rate (both directions hash every byte)
    buf = bytes(SHA_PROBE_BYTES)
    t0 = time.perf_counter()
    hashlib.sha256(buf).hexdigest()
    sha_rate = SHA_PROBE_BYTES / (time.perf_counter() - t0) / 1e9
    del buf
    say("snapshot", dir=os.path.dirname(tmp), snapshot_gb=f"{gb:.3f}",
        save_s=f"{save_s:.3f}", load_s=f"{load_s:.3f}",
        save_gb_per_s=f"{gb / save_s:.3f}",
        load_gb_per_s=f"{gb / load_s:.3f}",
        fsync_s=f"{fsync['fsync_path']:.3f}",
        host_sha256_gb_per_s=f"{sha_rate:.3f}")

    _same_state(ctx, restored)
    say("serve", warm_start_s=f"{load_s:.3f}", live_docs=restored.live_docs,
        terms=restored.vocab_size, live_blocks=restored.n_blocks,
        cold_blocks=restored.cold_blocks(),
        scopes=",".join(restored.scope_names()), state_equal=True,
        tenants=",".join(server.tenants))
    hashed = []
    block_signatures = sk.block_signatures
    sk.block_signatures = lambda *a: hashed.append(1) or block_signatures(*a)
    try:
        sig2 = restored.term_signatures(num_perm=sk.DEFAULT_NUM_PERM)
    finally:
        sk.block_signatures = block_signatures
    if hashed or not torch.equal(sig, sig2):
        raise AssertionError(f"the restore rehashed {len(hashed)} blocks or "
                             "its signatures differ")
    del sig, sig2
    if _fused_edges(restored, dev, seeds) != _fused_edges(ctx, dev, seeds):
        raise AssertionError("restored fused batch != live")
    net2 = materialize(restored, k=MAT_K, scope="all-time", mode="approx",
                       method="pallas", row_tile=ROW_TILE)
    if not _same_approx(net, net2):
        raise AssertionError("restored all-time approx network != live")
    block = _pad_block(synthetic_csl(STREAM_BLOCK, ctx.vocab_size, seed=3))
    slots = [c.ingest(*block, scope="rounds") for c in (ctx, restored)]
    if not np.array_equal(*slots):
        raise AssertionError("the next ingest took other slots")
    _same_state(ctx, restored)
    if _fused_edges(restored, dev, seeds) != _fused_edges(ctx, dev, seeds):
        raise AssertionError("fused batch after the next ingest != live")
    peak = torch.cuda.max_memory_allocated() / 1e9
    alive = weakref.ref(ctx)             # the server keeps the restored one
    del ctx, restored, net, net2
    if alive() is not None:
        raise AssertionError("the live windowed context outlived its last "
                             "use")
    torch.cuda.empty_cache()
    say("snapshot", restored_equal=True, rehashed_blocks=0,
        fused_identical=True, approx_identical=True,
        next_ingest_identical=True, max_memory_allocated_gb=f"{peak:.3f}",
        seconds=f"{time.perf_counter() - t_phase:.1f}")
    return {"server": server, "gamma_docs": gamma_docs}


def _serve_config():
    """The serve phase's server: 8 queries a batch, 4 executors a lane,
    queues of at most 64, shed past an estimated 250 ms wait, 500 ms
    deadlines, 2 ms linger; the reference's 2000 ms cold-plan prior."""
    from repro_torch.serve import AdmissionPolicy, ServerConfig
    return ServerConfig(q_batch=Q_BATCH, compile_budget=SERVE_BUDGET,
                        policy=AdmissionPolicy(max_queue_depth=SERVE_QUEUE,
                                               max_wait_ms=SERVE_WAIT_MS),
                        default_deadline_ms=SERVE_DEADLINE_MS,
                        linger_ms=SERVE_LINGER_MS)


def _serve_tenants(dev):
    """alpha pinned to the ring's tag scope "rounds", beta unscoped (both
    on the shared lane), gamma on a dedicated context of the mid-size CSL
    corpus; returns the tenants and gamma's docs."""
    from repro_torch.core import QueryContext
    from repro_torch.data import synthetic_csl
    from repro_torch.serve import TenantConfig
    docs = synthetic_csl(MID_DOCS, MID_TERMS, seed=4)
    gamma = QueryContext.from_docs(docs, MID_TERMS, device=dev)
    return [TenantConfig("alpha", scope="rounds"), TenantConfig("beta"),
            TenantConfig("gamma", ctx=gamma)], docs


def _serve_seeds(df, rng, n):
    """``n`` seeds, head (the 256 most frequent terms) and tail (df 1..64)
    in turns, drawn with replacement."""
    head = rng.choice(np.argsort(-df, kind="stable")[:256], n)
    tail = rng.choice(np.flatnonzero((df >= 1) & (df <= 64)), n)
    return [int(x) for x in np.stack([head, tail], 1).reshape(-1)[:n]]


def _serve_request(plan, seed, method="fused"):
    depth, topk, beam = plan
    return dict(seeds=[seed], depth=depth, topk=topk, beam=beam,
                method=method)


def _serve_trace(rng, rate, pools, ingest_blocks):
    """The reference serving bench's trace (``_build_trace``): steady
    Poisson arrivals at ``rate`` over alpha, beta and gamma and the two hot
    plans, a zero-spaced beta burst at the midpoint, one-off hostile plans
    through the first half, evicting alpha ingests spread over the whole."""
    events, t = [], 0.0
    for i in range(SERVE_STEADY):
        t += float(rng.exponential(1.0 / rate))
        tenant = ("alpha", "beta", "gamma")[i % 3]
        pool = pools[tenant]
        events.append(dict(t=t, kind="steady", tenant=tenant, request=(
            _serve_request(SERVE_HOT[i % 2], pool[i % len(pool)],
                           "pallas" if tenant == "gamma" else "fused")),
            deadline_ms=None))
    t_mid = events[len(events) // 2]["t"]
    pool = pools["beta"]
    for i in range(SERVE_BURST):
        events.append(dict(t=t_mid, kind="burst", tenant="beta",
                           request=_serve_request(SERVE_HOT[0],
                                                  pool[i % len(pool)]),
                           deadline_ms=None))
    for i in range(SERVE_HOSTILE):
        events.append(dict(t=t_mid * (i + 1) / (SERVE_HOSTILE + 1),
                           kind="hostile", tenant="beta",
                           request=_serve_request((1, 2 + i, 8 * (i + 2)),
                                                  pool[i]),
                           deadline_ms=300_000.0))
    t_end = max(e["t"] for e in events)
    for i, docs in enumerate(ingest_blocks):
        events.append(dict(t=t_end * (i + 0.5) / len(ingest_blocks),
                           kind="ingest", tenant="alpha", docs=docs))
    events.sort(key=lambda e: e["t"])
    return events


async def _serve_replay(server, events):
    """Fire every event at its trace time, open loop; returns the
    (kind, response) pairs, each ingest's (ms, cold blocks after it) and
    the wall seconds."""
    import asyncio
    t0 = time.monotonic()
    ingests = []

    async def fire(ev):
        delay = ev["t"] - (time.monotonic() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        if ev["kind"] == "ingest":
            t = time.perf_counter()
            await server.ingest(ev["tenant"], ev["docs"])
            ingests.append(((time.perf_counter() - t) * 1e3,
                            server.ctx.cold_blocks()))
            return None
        return ev["kind"], await server.submit(
            ev["tenant"], ev["request"], deadline_ms=ev["deadline_ms"])

    tasks = [asyncio.create_task(fire(ev)) for ev in events]
    out = await asyncio.gather(*tasks)
    return [r for r in out if r is not None], ingests, time.monotonic() - t0


async def _serve_checked(server, dev, pool, gamma_pool, gamma_hidx):
    """``SERVE_CHECKED`` requests of each hot plan (alpha and beta in
    turns) == a direct ``CoocEngine`` on the server's context at the same
    epoch, slot for slot; ``N_ORACLE`` of gamma's == the host oracle."""
    import asyncio
    from repro_torch.serve import CoocEngine
    resps = []
    for plan in SERVE_HOT:
        resps += await asyncio.gather(*[server.submit(
            ("alpha", "beta")[j % 2], _serve_request(plan, pool[j]),
            deadline_ms=600_000.0) for j in range(SERVE_CHECKED)])
    gamma = [(s, _serve_request(SERVE_HOT[1], s, "pallas"))
             for s in gamma_pool[:N_ORACLE]]
    gamma_resps = await asyncio.gather(*[
        server.submit("gamma", r, deadline_ms=600_000.0) for _, r in gamma])
    bad = [r.status for r in resps + list(gamma_resps) if not r.ok]
    if bad:
        raise AssertionError(f"checked requests not served: {bad}")

    def direct():
        ctx = server.ctx
        eng = CoocEngine(ctx, device=dev, q_batch=Q_BATCH)
        futs = [eng.submit(r.result.spec) for r in resps]
        eng.run_until_drained()
        for r, f in zip(resps, futs):
            want = f.result()
            if r.result.epoch != want.epoch or want.epoch != ctx.epoch:
                raise AssertionError(f"served at epoch {r.result.epoch}, "
                                     f"checked at {want.epoch}")
            if not all(np.array_equal(a, b) for a, b in
                       zip(r.result.network, want.network)):
                raise AssertionError(f"served {r.result.spec} != a direct "
                                     "engine")
            check_network(r.result, ctx.vocab_size)
        depth, topk, beam = SERVE_HOT[1]
        for (s, _), r in zip(gamma, gamma_resps):
            if r.result.edges() != oracle_edges(gamma_hidx, [s], depth, topk,
                                                beam):
                raise AssertionError(f"gamma seed {s} != host oracle")
        return len(resps), len(gamma)

    return await asyncio.get_running_loop().run_in_executor(None, direct)


async def _serve_run(dev, server, pools, gamma_hidx, ingest_blocks, rng):
    import asyncio
    import contextlib
    import torch
    from repro_torch.kernels import ops
    out = {}
    shared = server._lanes["shared"]
    steps = []                           # every shared-lane step's ms
    observe = shared.model.observe

    def record(key, ms):
        steps.append(ms)
        observe(key, ms)

    shared.model.observe = record
    head = pools["beta"][0]
    await server.start()
    try:
        # the reference bench's preamble: fill the LRU with one-off plans,
        # then warm the hot plans, which evict some of them
        for i in range(SERVE_BUDGET):
            r = await server.submit("beta", _serve_request((1, 2 + i, 8), head),
                                    deadline_ms=600_000.0)
            if r.result is None:
                raise AssertionError(f"preamble plan {i}: {r}")
        for plan in SERVE_HOT:
            for tenant, method in (("beta", "fused"), ("gamma", "pallas")):
                r = await server.submit(
                    tenant, _serve_request(plan, pools[tenant][0], method),
                    deadline_ms=600_000.0)
                if not r.ok:
                    raise AssertionError(f"warm-up {tenant} {plan}: {r}")
        # a plan never seen: its first step, then three more
        n0 = len(steps)
        for _ in range(4):
            r = await server.submit("beta", _serve_request(SERVE_NEW, head),
                                    deadline_ms=600_000.0)
            if not r.ok:
                raise AssertionError(f"new plan: {r}")
        out["cold_first_step_ms"] = steps[n0]
        out["warm_step_ms"] = float(np.mean(steps[n0 + 1:]))
        # capacity: full batches of each hot plan, closed loop
        pool = pools["beta"]
        out["step_ms"] = {}
        for plan in SERVE_HOT:
            n0 = len(steps)
            for b in range(SERVE_CAPACITY_BATCHES):
                rs = await asyncio.gather(*[server.submit(
                    "beta", _serve_request(plan, pool[(b * Q_BATCH + j)
                                                      % len(pool)]),
                    deadline_ms=600_000.0) for j in range(Q_BATCH)])
                if not all(r.ok and r.result.batch_occupancy == Q_BATCH
                           for r in rs):
                    raise AssertionError(f"capacity batch {b} of {plan} was "
                                         "not one full batch")
            out["step_ms"][plan] = steps[n0:]
        every = [ms for v in out["step_ms"].values() for ms in v]
        out["capacity_qps"] = Q_BATCH / (float(np.mean(every)) / 1e3)
        out["checked_before"] = await _serve_checked(
            server, dev, pool, pools["gamma"], gamma_hidx)

        events = _serve_trace(rng, SERVE_LOAD * out["capacity_qps"], pools,
                              ingest_blocks)
        cold0 = server.ctx.cold_blocks()
        n0 = len(steps)
        ops.reset_launches()
        out["responses"], out["ingests"], out["wall_s"] = \
            await _serve_replay(server, events)
        out["launches"] = {name: ops.LAUNCHES[name] for name in
                           ("level_step", "postings_counts")}
        out["trace_step_ms"] = steps[n0:]
        out["cold_before"] = cold0
        out["snapshot"] = server.snapshot()
        out["lane_plans"] = {name: lane.engine.compiled_plans
                             for name, lane in server._lanes.items()}
        out["checked_after"] = await _serve_checked(
            server, dev, pool, pools["gamma"], gamma_hidx)

        # one full "fused" batch of the paper's query, under the profiler
        # (started on this thread; the kernels launch from the executor's;
        # no profile where there is no card, the CPU rehearsal)
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
              if torch.cuda.is_available() else contextlib.nullcontext()
              ) as prof:
            t0 = time.perf_counter()
            rs = await asyncio.gather(*[server.submit(
                "beta", _serve_request(SERVE_HOT[1], s),
                deadline_ms=600_000.0) for s in pool[:Q_BATCH]])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if not all(r.ok and r.result.batch_occupancy == Q_BATCH for r in rs):
            raise AssertionError("the profiled batch was not one full batch")
        out["profile"] = None if prof is None else (wall_ms,
                                                    *device_times(prof))
    finally:
        await server.stop()
        shared.model.observe = observe
    return out


@serving
def phase_serve(dev, state):
    """The multi-tenant server on the stream ring warm-started by the
    snapshot phase: capacity in a closed loop, then the reference serving
    bench's open-loop trace at half of it (steady traffic over three
    tenants, a burst, hostile one-off plans, evicting ingests), held to
    the bench's acceptance checks; served answers == a direct engine and
    the host oracle before and after the trace."""
    import asyncio
    import torch
    from repro_torch.core import build_host_index
    from repro_torch.data import synthetic_csl

    t_phase = time.perf_counter()
    server, gamma_docs = state.pop("server"), state.pop("gamma_docs")
    ctx = server.ctx
    gamma_ctx = server.tenants["gamma"].ctx
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(5)
    shared_pool = _serve_seeds(ctx.index.doc_freq.cpu().numpy(), rng,
                               SERVE_STEADY)
    pools = {"alpha": shared_pool, "beta": shared_pool,
             "gamma": _serve_seeds(gamma_ctx.index.doc_freq.cpu().numpy(),
                                   rng, SERVE_STEADY)}
    gamma_hidx = build_host_index(gamma_docs, gamma_ctx.vocab_size)
    stream = synthetic_csl(SERVE_INGESTS * STREAM_BLOCK, ctx.vocab_size,
                           seed=2)
    blocks = [stream[lo:lo + STREAM_BLOCK]
              for lo in range(0, len(stream), STREAM_BLOCK)]
    out = asyncio.run(_serve_run(dev, server, pools, gamma_hidx, blocks,
                                     rng))

    step_ms = {f"d{p[0]}k{p[1]}b{p[2]}": f"{np.mean(v):.3f}"
               for p, v in out["step_ms"].items()}
    say("serve", capacity_qps=f"{out['capacity_qps']:.3f}",
        capacity_batches=SERVE_CAPACITY_BATCHES,
        mean_step_ms=json.dumps(step_ms),
        cold_first_step_ms=f"{out['cold_first_step_ms']:.3f}",
        warm_step_ms=f"{out['warm_step_ms']:.3f}",
        new_plan="d{}k{}b{}".format(*SERVE_NEW),
        checked_before=json.dumps(out["checked_before"]))

    resps = out["responses"]
    snap = out["snapshot"]
    by = {}
    for kind, r in resps:
        key = f"{kind}:{r.status}" + (f":{r.reason}" if r.status == "shed"
                                      else "")
        by[key] = by.get(key, 0) + 1
    shed = [r for _, r in resps if r.status == "shed"]
    admitted = len(resps) - len(shed)
    misses = sum(r.status == "deadline_miss" for _, r in resps)
    errors = [r.reason for _, r in resps if r.status == "error"]
    served = [r.latency_ms for _, r in resps if r.result is not None]
    p50, p95, p99, p999 = np.percentile(served, [50, 95, 99, 99.9])
    ingest_ms = [ms for ms, _ in out["ingests"]]
    cold = [out["cold_before"]] + [c for _, c in out["ingests"]]
    say("serve", offered=len(resps), served=len(served),
        wall_s=f"{out['wall_s']:.3f}",
        offered_qps=f"{SERVE_LOAD * out['capacity_qps']:.3f}",
        served_qps=f"{len(served) / out['wall_s']:.3f}",
        p50_ms=f"{p50:.3f}", p95_ms=f"{p95:.3f}", p99_ms=f"{p99:.3f}",
        p999_ms=f"{p999:.3f}",
        shed_queue_full=sum(r.reason == "queue_full" for r in shed),
        shed_est_wait=sum(r.reason == "est_wait" for r in shed),
        shed_rate=f"{snap.shed_rate:.6f}", misses=misses,
        deadline_miss_rate_admitted=f"{misses / max(admitted, 1):.6f}",
        deadline_miss_rate=f"{snap.deadline_miss_rate:.6f}",
        errors=len(errors), peak_queue_depth=snap.peak_queue_depth,
        compiled_plans=json.dumps(out["lane_plans"]),
        plan_evictions=snap.plan_evictions,
        by_kind=json.dumps(by, sort_keys=True))
    shared = sum(1 for _, r in resps if r.result is not None
                 and r.tenant != "gamma")
    trace_ms = out["trace_step_ms"]
    say("serve", shared_steps=len(trace_ms),
        shared_mean_occupancy=f"{shared / max(len(trace_ms), 1):.3f}",
        shared_mean_step_ms=f"{np.mean(trace_ms):.3f}",
        shared_busy_share=f"{sum(trace_ms) / 1e3 / out['wall_s']:.3f}")
    say("serve", ingests=len(ingest_ms),
        ingest_ms=json.dumps([round(x, 3) for x in ingest_ms]),
        cold_blocks=json.dumps(cold),
        launches=json.dumps(out["launches"]),
        checked_after=json.dumps(out["checked_after"]))
    if out["profile"] is None:
        say("serve", profile="fused_batch", device_busy_ms="not-measured")
    else:
        wall_ms, busy, kernels = out["profile"]
        say("serve", profile="fused_batch", wall_ms=f"{wall_ms:.4f}",
            device_busy_ms=f"{busy:.4f}",
            idle_share=f"{max(0.0, 1 - busy / wall_ms):.3f}",
            top_kernels=json.dumps(kernels))
    # the reference bench's acceptance, and this port's own
    failed = []
    if by.get("burst:shed:queue_full", 0) == 0:
        failed.append("the burst was not shed at queue_full")
    if snap.peak_queue_depth > SERVE_QUEUE:
        failed.append(f"peak queue depth {snap.peak_queue_depth}")
    if max(out["lane_plans"].values()) > SERVE_BUDGET:
        failed.append(f"compiled plans {out['lane_plans']}")
    if snap.plan_evictions == 0:
        failed.append("no plan was evicted")
    if errors:
        failed.append(f"{len(errors)} error responses: {errors[:3]}")
    if misses >= 0.01 * admitted:
        failed.append(f"{misses} deadline misses of {admitted} admitted")
    if not all(out["launches"].values()):
        failed.append(f"a kernel was not launched: {out['launches']}")
    if len(ingest_ms) != SERVE_INGESTS or any(
            b <= a for a, b in zip(cold, cold[1:])):
        failed.append(f"an ingest spilled no block: cold blocks {cold}")
    if failed:
        raise AssertionError("serve: " + "; ".join(failed))
    peak = torch.cuda.max_memory_allocated() / 1e9
    alive = weakref.ref(ctx)
    del server, ctx, gamma_ctx, out, resps, snap, shed
    if alive() is not None:
        raise AssertionError("the served context outlived its last use")
    torch.cuda.empty_cache()
    say("serve", acceptance=True, max_memory_allocated_gb=f"{peak:.3f}",
        seconds=f"{time.perf_counter() - t_phase:.1f}")


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


def sparse_work(masks, v):
    """What kernel 1 walks: its row tiles' active words summed, and the
    AND+popcounts it issues, Σ_tiles active words x tile rows x V (at 4
    rows a tile no listed group of four rows is all zero)."""
    from repro_torch.kernels import postings, ref
    active = int(ref.active_words_ref(masks, postings.ROWS)[1].sum())
    return active, active * postings.ROWS * v


@serving
def phase_kernels(dev, ctx, seeds, launches):
    """Each kernel at the main path's shapes: kernels 1 and 2 at the
    level-0, level-1 and level-2 frontiers of the first CSL batch, through
    the same code the engine runs (the JSON entries are level 1's); kernel
    3 at groups of 1, 2, 4 and 8 row blocks of the whole-network sweep
    (the JSON entry is GROUP's, the sweep's own); the row top-k on one
    row group's counts at the CSL width and at MESH_TERMS (the JSON entry
    is the CSL width's)."""
    import torch
    from repro_torch.core import unpack_bitmap
    from repro_torch.core.cooccurrence import _expand_level, initial_state
    from repro_torch.core.materialize import GROUP
    from repro_torch.kernels import ops, postings, ref

    seed_rows = torch.tensor(seeds[:Q_BATCH]).reshape(Q_BATCH, 1)
    fronts = [initial_state(ctx.index, seed_rows, beam=BEAM)]
    for _ in range(2):
        fronts.append(_expand_level(ctx.index, fronts[-1], Q_BATCH, TOPK,
                                    True, "fused", ctx.operands("fused"))[0])
    st = fronts[1]                      # the level-1 frontier
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
    want, plain_ms = _event_ms(lambda: ref.postings_counts_ref(
        st.masks, packed, chunk_bytes=2 << 30))
    err = int((got - want).abs().max())
    if err != 0:
        raise AssertionError("postings kernel != plain at the CSL shapes")
    del want
    ms = cuda_ms(lambda: ops.postings_counts(st.masks, packed), 5)
    bound_ms, bound_by, n_ops, n_bytes = _bound(
        nonzero_words, active_words, r * v * 4, r * w * 4, v, sms, hz)
    # yardstick (not used by the port): one int8 tensor-core product of the
    # unpacked 0/1 operands, exact in int32 like the kernel, against the
    # context's column-major dense incidence
    xd = ctx.x_dense()
    m8 = unpack_bitmap(st.masks, torch.int8)
    lib = torch._int_mm(m8, xd)[:, :v]
    lib_err = int((lib - got).abs().max())
    if lib_err != 0:
        raise AssertionError("postings kernel != torch._int_mm at the CSL "
                             "shapes")
    del lib
    lib_ms = cuda_ms(lambda: torch._int_mm(m8, xd), 3)
    del m8
    # the work the row tiles walk, and the compaction launch's share of the
    # time (the launcher called directly: these launches are not counted)
    active_t, issued = sparse_work(st.masks, v)
    n_t = postings.active_words_cuda(st.masks)[1]
    if int(n_t.sum()) != active_t:
        raise AssertionError(f"compaction found {int(n_t.sum())} active "
                             f"words, not {active_t}")
    say("kernels", kernel="postings_counts", frontier="level-1",
        tile_rows=postings.ROWS, active_words=active_t,
        nonzero_words=nonzero_words, issued_popcounts=issued,
        needed_popcounts=nonzero_words * v,
        compaction_ms=f"{cuda_ms(lambda: postings.active_words_cuda(st.masks), 5):.4f}")
    # the level-0 frontier (one nonzero row a query, so almost no
    # popcounts: its time is the gather of the active packed rows) and
    # the level-2 frontier
    for level in (0, 2):
        m = fronts[level].masks
        if not torch.equal(postings.postings_counts_cuda(m, packed),
                           ref.postings_counts_ref(m, packed,
                                                   chunk_bytes=2 << 30)):
            raise AssertionError(f"postings kernel != plain at the "
                                 f"level-{level} frontier")
        active_l, issued_l = sparse_work(m, v)
        ms_l = cuda_ms(lambda: postings.postings_counts_cuda(m, packed), 5)
        say("kernels", kernel="postings_counts", frontier=f"level-{level}",
            tile_rows=postings.ROWS, active_words=active_l,
            nonzero_words=int((m != 0).sum()), issued_popcounts=issued_l,
            ms=f"{ms_l:.4f}")
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
    del got

    # fused level step, at each frontier, over the index's own postings
    entry = None
    for level, stf in enumerate(fronts):
        args = (stf.masks, packed, stf.terms, stf.valid, stf.visited)
        got = ops.level_step(*args, v=v, k=TOPK, dedup=True)
        want, plain_ms = _event_ms(lambda: ref.level_step_ref(
            *args, v=v, k=TOPK, dedup=True, chunk_bytes=2 << 30))
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"level_step kernel != plain at the CSL "
                                 f"level-{level} frontier")
        err = int((got[0] - want[0]).abs().max())
        ms = cuda_ms(lambda: ops.level_step(*args, v=v, k=TOPK, dedup=True),
                     5)
        nzl = stf.masks != 0
        vis_bytes = stf.visited.numel() + 2 * r * 4  # visited, terms, valid
        bound_ms, bound_by, n_ops, n_bytes = _bound(
            int(nzl.sum()), int(nzl.any(dim=0).sum()),
            2 * r * TOPK * 4 + vis_bytes, r * w * 4, v, sms, hz)
        say("kernels", kernel="level_step", frontier=f"level-{level}",
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, popcounts=n_ops,
            bytes=n_bytes, active_words=sparse_work(stf.masks, v)[0])
        if level == 1:
            entry = {"name": "level_step", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/level_step.cu",
                     "replaces": "src/repro/kernels/level_step.py:109",
                     "launches": launches["level_step"], "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None}
        del got, want
    out.append(entry)

    # co-occurrence counts: the first 1, 2, 4 and 8 row blocks of the
    # sweep, their unpacked masks (g * ROW_TILE, D) against the whole dense
    # incidence, beside torch._int_mm on the same operands
    d, vp = xd.shape
    entry = None
    for g in sorted({1, 2, 4, 8, GROUP}):
        m = g * ROW_TILE
        x_l = unpack_bitmap(pt[:m, :w], torch.int8).t()
        before = ops.COOCCUR_PATHS["tma"]
        got = ops.cooccur_counts(x_l, xd)
        path = "tma" if ops.COOCCUR_PATHS["tma"] == before + 1 else "bytes"
        if path != "tma":
            raise AssertionError(f"cooccur kernel took its {path} path at "
                                 f"{m} CSL rows")
        lib = torch._int_mm(x_l.t(), xd)
        err = int((got - lib).abs().max())
        del lib
        plain_ms = None
        if g in (1, GROUP):
            want, plain_ms = _event_ms(lambda: ref.cooccur_counts_ref(
                x_l, xd, chunk_bytes=2 << 30))
            if not torch.equal(got, want):
                raise AssertionError(f"cooccur kernel != plain at {m} CSL "
                                     "rows")
            del want
        if err != 0:
            raise AssertionError(f"cooccur kernel != _int_mm at {m} CSL rows")
        del got
        ms = cuda_ms(lambda: ops.cooccur_counts(x_l, xd), 3)
        lib_ms = cuda_ms(lambda: torch._int_mm(x_l.t(), xd), 3)
        n_ops = 2 * m * d * vp
        n_bytes = m * d + d * vp + m * vp * 4
        bound_ms, bound_by = _bound_ms(n_bytes, n_ops, INT8_OPS_PER_S)
        say("kernels", kernel="cooccur_counts", row_blocks=g, rows=m,
            docs=d, terms=vp, path=path, ms=f"{ms:.4f}",
            ms_per_row_block=f"{ms / g:.4f}",
            plain_ms="not-timed" if plain_ms is None else f"{plain_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, int8_ops=n_ops,
            bytes=n_bytes, int8_mm_ms=f"{lib_ms:.4f}",
            int8_mm_ms_per_row_block=f"{lib_ms / g:.4f}",
            tops=f"{n_ops / ms / 1e9:.1f}")
        if g == GROUP:
            entry = {"name": "cooccur_counts", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/cooccur.cu",
                     "replaces": "src/repro/kernels/cooccur.py:36",
                     "launches": launches["cooccur_counts"],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms}
        del x_l
    out.append(entry)

    # the per-row top-k of one row group's counts (the sweep's reduction
    # of each group) at CSL's width and, packed, at MeSH's (rows not
    # 16-byte aligned), beside its plain version and the torch.topk over
    # int64 keys that it replaced (the plain version's top-k alone)
    m = GROUP * ROW_TILE
    x_l = unpack_bitmap(pt[:m, :w], torch.int8).t()
    full = ops.cooccur_counts(x_l, xd)[:, :v]
    del x_l
    entry = None
    for width in (v, min(MESH_TERMS, v)):
        cnt = full[:, :width].contiguous()
        got = ops.row_top_k(cnt, 0, MAT_K)
        want, plain_ms = _event_ms(lambda: ref.row_top_k_ref(cnt, 0, MAT_K))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"row top-k kernel != plain at {m} x "
                                 f"{width} counts")
        ms = cuda_ms(lambda: ops.row_top_k(cnt, 0, MAT_K), 20)
        lib_ms = cuda_ms(lambda: ref.topk_lower_index(cnt, MAT_K), 3)
        n_bytes = cnt.numel() * 4 + m * MAT_K * 12
        bound_ms, bound_by = _bound_ms(n_bytes, 0, 1.0)
        say("kernels", kernel="row_topk", rows=m, terms=width, k=MAT_K,
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, bytes=n_bytes,
            topk_int64_ms=f"{lib_ms:.4f}",
            gb_per_s=f"{n_bytes / ms / 1e6:.1f}")
        if entry is None:
            entry = {"name": "row_topk", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/row_topk.cu",
                     "replaces": "none: torch.topk over int64 keys "
                                 "(kernels/ref.py::topk_lower_index)",
                     "launches": launches["row_topk"], "max_abs_err": 0,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms}
        del cnt, got, want
    del full
    out.append(entry)
    return out


def _f64_mlp(mlp, x, final_act=False):
    n = len(mlp.w)
    for i, (w, b) in enumerate(zip(mlp.w, mlp.b)):
        x = x @ w.double() + b.double()
        if i < n - 1 or final_act:
            x = x.clamp(min=0)
    return x


def dlrm_rows_f64(cfg, model, batch, rows):
    """The logits of ``rows`` of ``batch``, recomputed in float64 through
    plain torch code (gather, MLPs, full Gram, triangle)."""
    import torch
    ids = batch["sparse_ids"][rows].to(torch.int64)
    offs = torch.arange(cfg.n_sparse, device=ids.device) * cfg.vocab_per_field
    emb = model.table[ids + offs[None, :]].double()               # (n, F, E)
    dense_vec = _f64_mlp(model.bot, batch["dense"][rows].double(), True)
    x = torch.cat([dense_vec[:, None, :], emb], dim=1)
    gram = x @ x.transpose(1, 2)
    ii, jj = torch.tril_indices(x.shape[1], x.shape[1], offset=-1,
                                device=x.device)
    top_in = torch.cat([dense_vec, gram[:, ii, jj]], dim=-1)
    return _f64_mlp(model.top, top_in)[:, 0]


def _check_dlrm_rows(cfg, model, batch, got, what, prob):
    """Hold N_DLRM_CHECKED sampled rows of ``got`` against float64."""
    import torch
    n = got.shape[0]
    rng = np.random.default_rng(n)
    rows = torch.from_numpy(rng.choice(n, min(N_DLRM_CHECKED, n),
                                       replace=False)).to(got.device)
    want = dlrm_rows_f64(cfg, model, batch, rows)
    if prob:
        want = torch.sigmoid(want)
    got_rows = got[rows].double()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"dlrm {what}: non-finite outputs")
    err = (got_rows - want).abs()
    if bool((err > DLRM_ATOL + DLRM_RTOL * want.abs()).any()):
        raise AssertionError(f"dlrm {what}: {len(rows)} sampled rows differ "
                             f"from float64 by up to {float(err.max()):.3g}")
    return float(err.max())


def device_profile(fn, top=6):
    """One run of ``fn`` under ``torch.profiler``: the host window (ms,
    ending in a synchronize), the device's busy time in it (the sum of its
    kernels' times, ms) and the ``top`` kernels by time.  None where there
    is no card (the CPU rehearsal)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        return None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return (wall_ms, *device_times(prof, top))


def device_times(prof, top=6):
    """The device's busy time in a profile (the sum of its kernels' times,
    ms, from whichever thread launched them) and its ``top`` kernels."""
    import torch
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name[:60]] = per.get(e.name[:60], 0.0) + e.device_time_total / 1e3
    busy = sum(per.values())
    kernels = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    return busy, [(n, round(ms, 4)) for n, ms in kernels]


def say_profile(phase, what, fn):
    prof = device_profile(fn)
    if prof is None:
        say(phase, profile=what, device_busy_ms="not-measured")
        return
    wall_ms, busy, kernels = prof
    say(phase, profile=what, wall_ms=f"{wall_ms:.4f}",
        device_busy_ms=f"{busy:.4f}",
        idle_share=f"{max(0.0, 1 - busy / wall_ms):.3f}",
        top_kernels=json.dumps(kernels))


@serving
def phase_dlrm(dev, launches):
    """dlrm-rm2 at full size (26 fields x 10^6 rows x 64 fp32) served at
    RECSYS_SHAPES' three serving cells through kernel 4."""
    import torch
    from repro_torch.configs import get_config, replace
    from repro_torch.data import recsys_batch
    from repro_torch.kernels import ops
    from repro_torch.models import recsys as R

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("fp32 matmuls must not run in TF32")
    cfg = replace(get_config("dlrm-rm2"), vocab_per_field=DLRM_VOCAB)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = R.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    say("dlrm", arch=cfg.name, fields=cfg.n_sparse,
        rows_per_field=cfg.vocab_per_field, embed=cfg.embed_dim,
        table_gb=f"{model.table.numel() * 4 / 1e9:.3f}",
        init_s=f"{time.perf_counter() - t0:.2f}",
        tf32=torch.backends.cuda.matmul.allow_tf32,
        matmul_precision=torch.get_float32_matmul_precision())

    def timed(fn, batch):
        return _timed_call(lambda: fn(cfg, model, batch))

    p99 = [R.as_batch(recsys_batch(cfg, SERVE_P99, step), dev)
           for step in range(N_P99_BATCHES + 1)]
    bulk = [R.as_batch(recsys_batch(cfg, SERVE_BULK, step), dev)
            for step in range(N_BULK_BATCHES + 1)]
    t0 = time.perf_counter()
    cand = R.as_batch(recsys_batch(cfg, RETRIEVAL_CAND, 0, seed=1), dev)
    cand_gen_s = time.perf_counter() - t0
    R.serve_fn(cfg, model, p99[-1])            # first use: allocator
    R.serve_fn(cfg, model, bulk[-1])

    ops.reset_launches()
    p99_ms, bulk_ms, out = [], [], {}
    for b in p99[:-1]:
        out["serve_p99"], ms = timed(R.serve_fn, b)
        p99_ms.append(ms)
    for b in bulk[:-1]:
        out["serve_bulk"], ms = timed(R.serve_fn, b)
        bulk_ms.append(ms)
    out["retrieval_cand"], cand_ms = timed(R.retrieval_fn, cand)
    counts = dict(ops.LAUNCHES)
    if counts["dot_interaction"] != N_P99_BATCHES + N_BULK_BATCHES + 1:
        raise AssertionError(f"dlrm launched dot_interaction "
                             f"{counts['dot_interaction']} times")
    launches["dot_interaction"] = counts["dot_interaction"]

    errs = {
        "serve_p99": _check_dlrm_rows(cfg, model, p99[-2], out["serve_p99"],
                                      "serve_p99", True),
        "serve_bulk": _check_dlrm_rows(cfg, model, bulk[-2],
                                       out["serve_bulk"], "serve_bulk", True),
        "retrieval_cand": _check_dlrm_rows(cfg, model, cand,
                                           out["retrieval_cand"],
                                           "retrieval_cand", False)}
    for name, n in (("serve_p99", SERVE_P99), ("serve_bulk", SERVE_BULK),
                    ("retrieval_cand", RETRIEVAL_CAND)):
        if out[name].shape != (n,):
            raise AssertionError(f"dlrm {name}: shape {out[name].shape}")
    p50, p99v = np.percentile(p99_ms, [50, 99])
    # rates over the whole window: every sample over the sum of batch times
    p99_rate = SERVE_P99 * len(p99_ms) / (sum(p99_ms) / 1e3)
    bulk_rate = SERVE_BULK * len(bulk_ms) / (sum(bulk_ms) / 1e3)
    say("dlrm", shape="serve_p99", batch=SERVE_P99, batches=len(p99_ms),
        p50_ms=f"{p50:.4f}", p99_ms=f"{p99v:.4f}",
        samples_per_s=f"{p99_rate:.1f}",
        max_abs_err_vs_f64=f"{errs['serve_p99']:.3g}")
    # the served id check's host cost a serve_p99 call: the flat row ids
    # (the gather needs them anyway), then the rows, the (B,) mask and
    # the NaN fill of the dense vector (models/recsys.py::interaction_input)
    ids = p99[0]["sparse_ids"]
    dense = torch.zeros((SERVE_P99, cfg.embed_dim), device=dev)

    def id_check():
        ok = R._served_rows(cfg, model.table, ids)[1]
        return torch.where(ok[:, None], dense, float("nan"))
    say("dlrm", shape="serve_p99", id_check_us=f"{call_us(id_check):.2f}",
        flat_ids_us=f"{call_us(lambda: R._flat_field_ids(cfg, ids)):.2f}")
    say("dlrm", shape="serve_bulk", batch=SERVE_BULK, batches=len(bulk_ms),
        ms=" ".join(f"{m:.3f}" for m in bulk_ms),
        samples_per_s=f"{bulk_rate:.1f}",
        max_abs_err_vs_f64=f"{errs['serve_bulk']:.3g}")
    say("dlrm", shape="retrieval_cand", candidates=RETRIEVAL_CAND,
        seconds=f"{cand_ms / 1e3:.4f}", batch_gen_s=f"{cand_gen_s:.2f}",
        max_abs_err_vs_f64=f"{errs['retrieval_cand']:.3g}")
    say_profile("dlrm", "serve_p99", lambda: R.serve_fn(cfg, model, p99[0]))
    say_profile("dlrm", "serve_bulk", lambda: R.serve_fn(cfg, model, bulk[0]))
    say("dlrm", launches=json.dumps(counts), rows_checked=N_DLRM_CHECKED,
        rtol=DLRM_RTOL, atol=DLRM_ATOL, max_memory_allocated_gb=
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    return cfg, model, {"serve_p99": p99[0], "serve_bulk": bulk[0],
                        "retrieval_cand": cand}


def decode_inputs(name, dtype, dev, ragged):
    """q, k, v at a decode cell from a seeded generator on the card, with
    ragged lengths from a seed (with B >= 3, row 0 length 0 and row 1
    length 1) or every length = S."""
    import torch
    hq, hkv, d = DECODE_HEADS
    b, s = DECODE_SHAPES[name]
    gen = torch.Generator(device=dev).manual_seed(s + b)
    q, k, v = (torch.randn(shape, generator=gen, device=dev, dtype=dtype)
               for shape in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    if ragged:
        ln = np.random.default_rng(s).integers(1, s + 1, b)
        if b >= 3:                         # and random rows beside them
            ln[:2] = 0, 1
    else:
        ln = np.full(b, s)
    return q, k, v, torch.from_numpy(ln.astype(np.int32)).to(dev)


def _check_decode(got, want, dtype, what):
    """Max abs err of kernel 5's ``got`` against the plain ``want`` (both
    (B, Hq, d)), raising where it exceeds DECODE_TOL."""
    import torch
    w = want.float()
    err = (got.float() - w).abs()
    if dtype == torch.bfloat16:
        rms = w.pow(2).mean(dim=(1, 2), keepdim=True).sqrt()
        lim = 2.0 ** -7 * w.abs() + 1e-3 * rms
    else:
        tol = DECODE_TOL["float32"]
        lim = tol + tol * w.abs()
    if not bool(torch.isfinite(got.float()).all()) or bool((err > lim).any()):
        raise AssertionError(f"flash_decode kernel != plain at {what}: "
                             f"max abs err {float(err.max()):.3g}")
    return float(err.max())


@serving
def phase_decode(dev, launches):
    """Kernel 5 through its public wrapper at llama3-8b's decode cells,
    ragged lengths (a 0 and a 1 among them), held against the plain
    version on the card."""
    import torch
    from repro_torch.kernels import ops, ref

    runs = [("decode_32k", torch.bfloat16), ("long_500k", torch.bfloat16),
            ("long_500k", torch.float32)]
    inputs = [decode_inputs(name, dt, dev, ragged=True) for name, dt in runs]
    ops.reset_launches()
    outs = [ops.flash_decode(*args) for args in inputs]
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    if counts["flash_decode"] != len(runs):
        raise AssertionError(f"decode launched flash_decode "
                             f"{counts['flash_decode']} times")
    launches["flash_decode"] = counts["flash_decode"]
    for (name, dt), args, got in zip(runs, inputs, outs):
        err = _check_decode(got, ref.flash_decode_ref(*args), dt, name)
        b, s = DECODE_SHAPES[name]
        say("decode", shape=name, dtype=str(dt).split(".")[-1], batch=b,
            seq=s, heads="x".join(map(str, DECODE_HEADS)),
            lengths=f"{int(args[3].min())}..{int(args[3].max())}",
            max_abs_err=f"{err:.3g}", tol=DECODE_TOL[str(dt).split('.')[-1]])
    del inputs, outs
    torch.cuda.empty_cache()
    say("decode", launches=json.dumps(counts), max_memory_allocated_gb=
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")


def _event_ms(fn):
    """Device time of one run of ``fn`` by CUDA events (no warm-up)."""
    import torch
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


def _bound_ms(n_bytes, n_ops, ops_per_s):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def kernel_device_ms(fn, calls):
    """Device time of one call of ``fn``: the kernels' own durations under
    ``torch.profiler`` (:func:`device_profile`) over ``calls`` back-to-back
    calls, summed and divided by ``calls``; the host's gaps between
    launches are not counted.  None where there is no card (the CPU
    rehearsal) or the profiler saw no kernel."""
    def repeat():                      # keeps no output alive
        for _ in range(calls):
            fn()

    fn()
    prof = device_profile(repeat)
    return prof[1] / calls if prof and prof[1] > 0 else None


def host_us(fn, calls):
    """Host time of one call of ``fn``: a host clock over ``calls``
    back-to-back calls ending in one synchronize, divided by ``calls``.
    Where the device takes longer than the host a call, this is the device
    time."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def _fmt(ms):
    return "not-measured" if ms is None else f"{ms:.4f}"


@serving
def phase_kernel_dot(dev, cfg, model, batches, launches):
    """Kernel 4 at the interaction input of each DLRM cell, beside its
    plain version, its bound and ``torch.bmm``'s full Gram.  Each is timed
    three ways: ``ms`` (CUDA events around 5 calls), ``device_ms`` (the
    kernels' own time under the profiler, kernel and bmm in turns) and
    ``host_us`` (a host clock over DOT_HOST_CALLS calls).  The JSON entry
    is serve_bulk's."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import recsys as R

    entry = None
    for name in ("serve_bulk", "serve_p99", "retrieval_cand"):
        _, x = R.interaction_input(cfg, model, batches[name])
        b, f, e = x.shape
        got = ops.dot_interaction(x)
        want, plain_ms = _event_ms(lambda: ref.dot_interaction_ref(x))
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"dot_interaction kernel != plain at {name}")
        del got, want
        ms = cuda_ms(lambda: ops.dot_interaction(x), 5)
        p = f * (f - 1) // 2
        n_bytes, n_ops = b * f * e * 4 + b * p * 4, 2 * b * p * e
        bound_ms, bound_by = _bound_ms(n_bytes, n_ops, FP32_OPS_PER_S)

        # yardstick (not used by the port): the full (B, F, F) Gram
        def kernel():
            return ops.dot_interaction(x)

        def bmm():
            return torch.bmm(x, x.mT)

        lib_ms = cuda_ms(bmm, 5)
        calls = DOT_DEVICE_CALLS[name]
        dev_ms = {kernel: [], bmm: []}
        for fn in (kernel, bmm, bmm, kernel):
            dev_ms[fn].append(kernel_device_ms(fn, calls))
        k_dev, b_dev = (None if None in v else sum(v) / len(v)
                        for v in dev_ms.values())
        k_host, b_host = (host_us(fn, DOT_HOST_CALLS) for fn in (kernel, bmm))
        say("kernels", kernel="dot_interaction", shape=name, batch=b,
            fields=f, embed=e, ms=f"{ms:.4f}", device_ms=_fmt(k_dev),
            host_us=f"{k_host:.2f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, bytes=n_bytes,
            flops=n_ops, bmm_full_gram_ms=f"{lib_ms:.4f}",
            bmm_device_ms=_fmt(b_dev), bmm_host_us=f"{b_host:.2f}",
            device_calls=calls, host_calls=DOT_HOST_CALLS,
            max_abs_err=f"{err:.3g}", gb_per_s=f"{n_bytes / ms / 1e6:.1f}")
        if entry is None:
            entry = {"name": "dot_interaction", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               "dot_interaction.cu",
                     "replaces": "src/repro/kernels/dot_interaction.py:32",
                     "launches": launches["dot_interaction"],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms, "device_ms": k_dev,
                     "host_us": k_host, "bmm_device_ms": b_dev,
                     "bmm_host_us": b_host}
        del x
    return entry


@serving
def phase_kernel_decode(dev, launches):
    """Kernel 5 at the decode cells with every length = S, beside its plain
    version, its bound and SDPA on (B, Hq, 1, d) queries against the
    (B, Hkv, S, d) views with ``enable_gqa=True`` and a boolean length mask
    (its memory above the inputs says whether it copies the cache); the
    JSON entry is decode_32k's."""
    import torch
    from repro_torch.kernels import ops, ref

    hq, hkv, d = DECODE_HEADS
    sdpa = torch.nn.functional.scaled_dot_product_attention
    entry = None
    for name in ("decode_32k", "long_500k"):
        q, k, v, ln = decode_inputs(name, torch.bfloat16, dev, ragged=False)
        b, s = DECODE_SHAPES[name]
        got = ops.flash_decode(q, k, v, ln)
        want, plain_ms = _event_ms(lambda: ref.flash_decode_ref(q, k, v, ln))
        err = _check_decode(got, want, torch.bfloat16, f"{name}, full")
        del want
        ms = cuda_ms(lambda: ops.flash_decode(q, k, v, ln), 5)
        cache = 2 * k.numel() * k.element_size()
        n_bytes = cache + 2 * q.numel() * q.element_size() + b * 4
        n_ops = 4 * b * hq * s * d
        bound_ms, bound_by = _bound_ms(n_bytes, n_ops, BF16_OPS_PER_S)
        # yardstick (not used by the port)
        ks, vs = k.transpose(1, 2), v.transpose(1, 2)      # (B, Hkv, S, d)
        mask = (torch.arange(s, device=dev)[None, :] < ln[:, None]
                )[:, None, None, :]

        def library():
            return sdpa(q[:, :, None, :], ks, vs, attn_mask=mask,
                        enable_gqa=True)

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        lib_err = float((library().reshape(b, hq, d).float() - got.float())
                        .abs().max())
        lib_ms = cuda_ms(library, 3)
        lib_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        say("kernels", kernel="flash_decode", shape=name, batch=b, seq=s,
            heads=f"{hq}x{hkv}x{d}", dtype="bfloat16", ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
            bound_by=bound_by, bytes=n_bytes,
            gb_per_s=f"{n_bytes / ms / 1e6:.1f}",
            sdpa_gqa_ms=f"{lib_ms:.4f}", sdpa_gqa_max_abs_err=f"{lib_err:.3g}",
            sdpa_gqa_transient_gb=f"{lib_gb:.3f}",
            sdpa_gqa_copies_cache=lib_gb > 0.5 * cache / 1e9,
            max_abs_err=f"{err:.3g}")
        say_profile("kernels", f"flash_decode {name}",
                    lambda: ops.flash_decode(q, k, v, ln))
        if name == "decode_32k":
            entry = {"name": "flash_decode", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
                     "replaces": "src/repro/kernels/flash_decode.py:69",
                     "launches": launches["flash_decode"],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms}
        del q, k, v, ks, vs, got
        torch.cuda.empty_cache()
    return entry


def lm_config(arch):
    from repro_torch.configs import get_config, replace
    return replace(get_config(arch), **LM_CONFIG_OVERRIDES.get(arch, {}))


def lm_prompts(cfg, n, seed):
    """``n`` prompts cut from ``lm_batch`` at seeded lengths in
    LM_PROMPT_LENS."""
    from repro_torch.data import lm_batch
    lo, hi = LM_PROMPT_LENS
    toks = lm_batch(cfg, n, hi, step=seed, seed=seed)["tokens"]
    lens = np.random.default_rng(seed).integers(lo, hi + 1, n)
    return [toks[i, :lens[i]].tolist() for i in range(n)]


def _lm_bytes(cfg, model, cache, batch, routed=None):
    """Bytes one decode step must move: every weight once but the
    embedding (its ``batch`` rows; the whole table where it is the head),
    the cache read once and its new entries written, the fp32 logits
    written.  ``routed``: per MoE layer the experts the step's tokens were
    routed to, where only those count; else every expert counts."""
    n = 0
    for name, p in model.named_parameters():
        nbytes = p.numel() * p.element_size()
        parts = name.split(".")
        if name == "embed":
            row = p.shape[1] * p.element_size()
            nbytes = nbytes if cfg.tie_embeddings else batch * row
        elif routed is not None and parts[0] == "moe_layers" \
                and parts[-1] in ("w1", "w2", "w3"):
            nbytes = nbytes * routed[int(parts[1])] // p.shape[0]
        n += nbytes
    kv = cache["kv"]
    entry = kv[:, :, 0].numel() * kv.element_size()
    return n + kv.numel() * kv.element_size() + entry \
        + batch * cfg.padded_vocab * 4


def _routed_experts(cfg, model, cache, tok):
    """One decode step with the MoE FFN watched: per MoE layer the number
    of distinct experts its tokens were routed to."""
    import torch
    from repro_torch.models import moe, transformer as T
    real, seen = moe.moe_ffn, []

    def watch(m, x, *, top_k, **kw):
        probs = torch.softmax(x.float() @ m.router, dim=-1)
        seen.append(len(set(moe._top_k(probs, top_k)[1].flatten().tolist())))
        return real(m, x, top_k=top_k, **kw)

    moe.moe_ffn = watch
    try:
        T.decode_step(cfg, model, cache, tok)
    finally:
        moe.moe_ffn = real
    return seen


def check_decode_against_prefill(cfg, model, done, logits_by_rid):
    """Each recorded decode step's logits of the requests in
    ``logits_by_rid`` against a fresh ``prefill`` over the prompt and the
    tokens served so far; raises past LM_DECODE_TOL.  Returns (worst, mean
    relative error, steps, steps whose argmax agrees)."""
    import torch
    from repro_torch.models import transformer as T
    by_rid = {r.rid: r for r in done}
    errs, agree = [], 0
    for rid, steps in logits_by_rid.items():
        req = by_rid[rid]
        if len(steps) != req.max_new_tokens - 1:
            raise AssertionError(f"request {rid}: {len(steps)} decode steps "
                                 f"recorded for {len(req.out_tokens)} tokens")
        for i, got in enumerate(steps):
            seq = req.prompt + req.out_tokens[:i + 1]
            want, _ = T.prefill(cfg, model, torch.tensor(
                [seq], dtype=torch.int32, device=got.device))
            want = want[0]
            err = float((got - want).abs().max() / want.abs().max())
            if not err <= LM_DECODE_TOL:
                raise AssertionError(
                    f"{cfg.name}: decode != prefill at request {rid} step "
                    f"{i}: max |diff| / max |logit| = {err:.4f} > "
                    f"{LM_DECODE_TOL}")
            errs.append(err)
            agree += int(torch.argmax(got) == torch.argmax(want))
    return max(errs), sum(errs) / len(errs), len(errs), agree


def _watched_server(srv, checked):
    """Time every prefill and decode step of ``srv`` (host clock, ending
    in a synchronize) and record the decode logits of the requests in
    ``checked``."""
    import torch
    rec = {rid: [] for rid in checked}
    times = {"prefill": [], "decode": []}
    decode, prefill = srv._decode, srv._prefill

    def timed(kind, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times[kind].append((time.perf_counter() - t0) * 1e3)
        return out

    def watched_decode(*args):
        logits, cache = timed("decode", decode, *args)
        for s, req in enumerate(srv.slot_req):
            if req is not None and req.rid in rec:
                rec[req.rid].append(logits[s].clone())
        return logits, cache

    srv._decode = watched_decode
    srv._prefill = lambda *args: timed("prefill", prefill, *args)
    return rec, times


def _lm_serve(dev, arch, n_req, new_tokens):
    """One arch at full width and depth through ``DecodeServer``."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import take
    from repro_torch.serve import DecodeServer
    cfg = lm_config(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params_gb = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 1e9
    say("lm", arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
        experts=f"{cfg.n_experts}x{cfg.top_k}+{cfg.n_shared_experts}"
        if cfg.moe else "dense", attention="mla" if cfg.mla else "gqa",
        params=cfg.n_params(), params_gb=f"{params_gb:.3f}",
        dtype="bfloat16", init_s=f"{init_s:.2f}")
    srv = DecodeServer(cfg, model, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                       device=dev)
    rec, times = _watched_server(srv, range(LM_CHECKED))
    prompts = lm_prompts(cfg, n_req, seed=1)
    for p in prompts:
        srv.submit(p, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = srv.run_until_drained()
    wall = time.perf_counter() - t0
    if sorted(r.rid for r in done) != list(range(n_req)) or any(
            len(r.out_tokens) != new_tokens or not r.done for r in done):
        raise AssertionError(f"{arch}: {len(done)} of {n_req} requests "
                             f"ended, not all with {new_tokens} tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out_tokens):
        raise AssertionError(f"{arch}: a token outside the vocabulary")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pre, dec = np.array(times["prefill"]), np.array(times["decode"])
    say("lm", arch=arch, requests=n_req, new_tokens=new_tokens,
        slots=LM_SLOTS, max_len=LM_MAX_LEN,
        prompt_lens=f"{min(map(len, prompts))}..{max(map(len, prompts))}",
        prefills=len(pre), prefill_ms_p50=f"{np.percentile(pre, 50):.3f}",
        prefill_ms_max=f"{pre.max():.3f}", decode_steps=len(dec),
        decode_ms_p50=f"{np.percentile(dec, 50):.3f}",
        decode_ms_p99=f"{np.percentile(dec, 99):.3f}",
        wall_s=f"{wall:.3f}",
        tokens_per_s=f"{n_req * new_tokens / wall:.1f}",
        peak_gb=f"{peak_gb:.3f}")
    worst, mean, steps, agree = check_decode_against_prefill(
        cfg, model, done, rec)
    say("lm", arch=arch, decode_vs_prefill_requests=len(rec),
        steps=steps, max_rel_err=f"{worst:.4f}", mean_rel_err=f"{mean:.4f}",
        argmax_agree=f"{agree}/{steps}", tol=LM_DECODE_TOL)
    del rec

    # one full decode step: every slot at its last position
    tok = torch.zeros(LM_SLOTS, dtype=torch.int32, device=dev)
    # its token embedding's host cost: take (the id check and the NaN
    # fill) against plain indexing
    say("lm", arch=arch, tokens=LM_SLOTS,
        embed_take_us=f"{call_us(lambda: take(model.embed, tok)):.2f}",
        embed_index_us=f"{call_us(lambda: model.embed[tok]):.2f}")
    cache = {"kv": srv.cache["kv"],
             "length": torch.tensor(srv.slot_pos, device=dev)}
    fields = {}
    if cfg.moe:
        routed = _routed_experts(cfg, model, cache, tok)
        fields["routed_experts_per_layer"] = f"{min(routed)}..{max(routed)}"
        fields["routed_bytes"] = _lm_bytes(cfg, model, cache, LM_SLOTS,
                                           routed)
        fields["routed_bound_ms"] = (
            f"{fields['routed_bytes'] / HBM_BYTES_PER_S * 1e3:.4f}")
    n_bytes = _lm_bytes(cfg, model, cache, LM_SLOTS)
    head = cfg.d_model * cfg.padded_vocab
    say("lm", arch=arch, step_bytes=n_bytes,
        bytes_bound_ms=f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f}",
        head_fp32_cast_gb=f"{head * 4 / 1e9:.3f}",
        cache_gb=f"{cache['kv'].numel() * 4 / 1e9:.3f}", **fields)
    # the profiler's own cost inflates its window, so the idle share is
    # also given against the unprofiled step's p50
    prof = device_profile(lambda: T.decode_step(cfg, model, cache, tok))
    if prof is None:
        say("lm", profile=f"{arch} decode_step", device_busy_ms="not-measured")
    else:
        wall_ms, busy, kernels = prof
        p50 = float(np.percentile(dec, 50))
        say("lm", profile=f"{arch} decode_step", wall_ms=f"{wall_ms:.4f}",
            device_busy_ms=f"{busy:.4f}",
            idle_share=f"{max(0.0, 1 - busy / wall_ms):.3f}",
            idle_share_of_p50=f"{max(0.0, 1 - busy / p50):.3f}",
            top_kernels=json.dumps(kernels))
    del srv, model, cache
    gc.collect()
    torch.cuda.empty_cache()


def _lm_card_against_cpu(dev, arch):
    """The same fp32 weights (LM_CPU_LAYERS layers at full width) served
    on the card and by the port on the CPU: identical greedy tokens,
    logits within LM_CPU_TOL of their max."""
    import torch
    from repro_torch.configs import replace
    from repro_torch.models import transformer as T
    from repro_torch.serve import DecodeServer
    cfg = lm_config(arch)
    kw = {"n_layers": LM_CPU_LAYERS}
    if cfg.moe:
        kw["first_dense_layers"] = 1
    cfg = replace(cfg, **kw)
    t0 = time.perf_counter()
    card = T.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                         device=dev, dtype=torch.float32)
    host = T.LM(cfg, device="cpu", dtype=torch.float32)
    host.load_state_dict(card.state_dict())
    prompts = lm_prompts(cfg, 2, seed=2)
    runs = []
    for model, where in ((card, dev), (host, "cpu")):
        srv = DecodeServer(cfg, model, slots=2, max_len=LM_MAX_LEN,
                           device=where)
        rec, _ = _watched_server(srv, (0, 1))
        for p in prompts:
            srv.submit(p, max_new_tokens=LM_CPU_NEW)
        runs.append(({r.rid: r.out_tokens for r in srv.run_until_drained()},
                     {k: [x.cpu() for x in v] for k, v in rec.items()}))
    (tok_card, log_card), (tok_cpu, log_cpu) = runs
    if tok_card != tok_cpu:
        raise AssertionError(f"{arch}: card tokens {tok_card} != CPU "
                             f"tokens {tok_cpu}")
    err = max(float((a - b).abs().max() / b.abs().max())
              for rid in log_cpu for a, b in zip(log_card[rid], log_cpu[rid]))
    if not err <= LM_CPU_TOL:
        raise AssertionError(f"{arch}: card logits != CPU logits: max |diff|"
                             f" / max |logit| = {err:.3g} > {LM_CPU_TOL}")
    say("lm", arch=arch, card_vs_cpu_layers=cfg.n_layers, dtype="float32",
        requests=len(tok_cpu), tokens_identical=True,
        steps=sum(map(len, log_cpu.values())), max_rel_err=f"{err:.3g}",
        tol=LM_CPU_TOL, seconds=f"{time.perf_counter() - t0:.1f}")
    del card, host
    gc.collect()
    torch.cuda.empty_cache()


@serving
def phase_lm(dev):
    """llama3-8b and deepseek-v2-lite-16b at full width and depth through
    ``DecodeServer``, decode held against prefill, then the card against
    the CPU at two layers; the five kernels are not on this path, so no
    launch count moves."""
    import torch
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    say("lm", start_allocated_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}",
        tf32=torch.backends.cuda.matmul.allow_tf32)
    before = dict(ops.LAUNCHES)
    for arch, (n_req, new_tokens) in LM_SERVED.items():
        _lm_serve(dev, arch, n_req, new_tokens)
    for arch in LM_SERVED:
        _lm_card_against_cpu(dev, arch)
    if ops.LAUNCHES != before:
        raise AssertionError(f"the lm phase launched kernels: {before} -> "
                             f"{ops.LAUNCHES}")
    say("lm", kernel_launches_moved=False,
        seconds=f"{time.perf_counter() - t0:.1f}")


# ---------------------------------------------------------------------------
# phase 14: the seed's side models
# ---------------------------------------------------------------------------


def side_config(arch):
    from repro_torch.configs import get_config, replace
    return replace(get_config(arch), **SIDE_CONFIG_OVERRIDES.get(arch, {}))


def _f64(t):
    return t.detach().cpu().numpy().astype(np.float64)


def _np_rmsnorm(x, g):
    return x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True) + 1e-5) * g


def _np_mlp(mlp, x):
    n = len(mlp.w)
    for i, (w, b) in enumerate(zip(mlp.w, mlp.b)):
        x = x @ _f64(w) + _f64(b)
        if i < n - 1:
            x = np.maximum(x, 0.0)
    return x


def deepfm_rows_f64(cfg, model, sparse_ids):
    """DeepFM logits of ``sparse_ids`` (n, F) recomputed in float64 numpy
    from the model's weights (the rows gathered on its device)."""
    import torch
    rows = (sparse_ids.to(torch.int64)
            + torch.arange(cfg.n_sparse, device=sparse_ids.device)
            * cfg.vocab_per_field)
    emb = _f64(model.table[rows])                              # (n, F, E)
    fo = _f64(model.fm_w[rows]).sum(-1) + float(model.fm_b)
    s = emb.sum(1)
    so = 0.5 * (s * s - (emb * emb).sum(1)).sum(-1)
    deep = _np_mlp(model.mlp, emb.reshape(emb.shape[0], -1))[:, 0]
    return fo + so + deep


def seq_hidden_f64(cfg, model, seq):
    """The last position's hidden state of ``seq`` (n, S), recomputed in
    float64 numpy: item and position embeddings, pre-norm blocks (causal
    for SASRec), the final norm."""
    import torch
    n, s = seq.shape
    h, e = cfg.n_heads, cfg.embed_dim
    dh = e // h
    x = _f64(model.item_emb[seq.to(torch.int64)]) + _f64(model.pos_emb)[:s]
    mask = np.tril(np.ones((s, s), bool)) if cfg.interaction == \
        "self-attn-seq" else np.ones((s, s), bool)
    for blk in model.blocks:
        p = {k: _f64(v) for k, v in blk.named_parameters()}
        xn = _np_rmsnorm(x, p["ln1"])
        q, k, v = ((xn @ p[w]).reshape(n, s, h, dh) for w in ("wq", "wk",
                                                              "wv"))
        sc = np.einsum("nqhd,nkhd->nhqk", q, k) / np.sqrt(dh)
        sc = np.where(mask, sc, -np.inf)
        sc = np.exp(sc - sc.max(-1, keepdims=True))
        pr = sc / sc.sum(-1, keepdims=True)
        o = np.einsum("nhqk,nkhd->nqhd", pr, v).reshape(n, s, e)
        x = x + o @ p["wo"]
        xn = _np_rmsnorm(x, p["ln2"])
        x = x + np.maximum(xn @ p["w1"] + p["b1"], 0.0) @ p["w2"] + p["b2"]
    return _np_rmsnorm(x, _f64(model.final_ln))[:, -1]


def _check_rows(what, got, want):
    """``got`` (fp32, any device) against float64 ``want`` within
    DLRM_RTOL / DLRM_ATOL; finite."""
    got = _f64(got)
    err = np.abs(got - want)
    if not np.isfinite(got).all() or (err > DLRM_ATOL
                                      + DLRM_RTOL * np.abs(want)).any():
        raise AssertionError(f"{what}: {got.shape[0]} sampled rows differ "
                             f"from float64 by up to {err.max():.3g}")
    return float(err.max())


def _sample_rows(n, k=None):
    rng = np.random.default_rng(n)
    return np.sort(rng.choice(n, min(k or N_SIDE_CHECKED, n), replace=False))


def side_batch(cfg, n, step, dev, seed=0):
    """A serving batch of ``n`` rows from ``recsys_batch``: the sparse ids
    (DeepFM), or the sequences with SIDE_CANDIDATES seeded candidates each
    (SASRec, BERT4Rec)."""
    from repro_torch.data import recsys_batch
    from repro_torch.models import recsys as R
    b = recsys_batch(cfg, n, step, seed=seed)
    if cfg.interaction == "fm":
        return R.as_batch({"sparse_ids": b["sparse_ids"]}, dev)
    cand = np.random.default_rng([seed, step]).integers(
        0, cfg.n_items, (n, SIDE_CANDIDATES)).astype(np.int32)
    return R.as_batch({"seq": b["seq"], "candidates": cand}, dev)


def _recsys_cost(cfg, model, rows, cands):
    """(bytes, fp32 operations) one call must move and do: every weight
    but the tables read once, the ids and the gathered table rows read
    once, the output written once; operations as the reference's cell
    model counts them (launch/cells.py), with 2 E a scored candidate."""
    e = cfg.embed_dim
    dense = sum(p.numel() for n, p in model.named_parameters()
                if n not in ("table", "fm_w", "item_emb"))
    if cfg.interaction == "fm":
        f = cfg.n_sparse
        dims = (f * e,) + tuple(cfg.mlp) + (1,)
        mlp = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
        return (4 * (dense + rows * f * (2 + e) + rows),
                rows * (mlp + 4 * f * e))
    s = cfg.seq_len
    per_tok = cfg.n_blocks * (2 * 4 * e * e + 2 * 2 * e * 4 * e)
    attn = cfg.n_blocks * 2 * 2 * s * s * e
    return (4 * (dense + rows * s * (1 + e) + cands * (2 + e)),
            rows * (s * per_tok + attn) + 2 * cands * e)


def _say_cost(phase, what, n_bytes, n_ops, ms):
    bound_ms, bound_by = _bound_ms(n_bytes, n_ops, FP32_OPS_PER_S)
    say(phase, cell=what, bytes=n_bytes, flops=n_ops,
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        roofline_share=f"{bound_ms / ms:.3f}")


def _side_recsys(dev, arch):
    """One recommender at full width: serve_p99, serve_bulk and
    retrieval_cand, 64 rows of each against float64."""
    import torch
    from repro_torch.models import recsys as R
    cfg = side_config(arch)
    seq = cfg.interaction != "fm"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = R.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    torch.cuda.synchronize()
    params_gb = sum(p.numel() * 4 for p in model.parameters()) / 1e9
    say("side", arch=arch, interaction=cfg.interaction,
        table_rows=(cfg.n_items + 2 if seq else cfg.n_sparse *
                    cfg.vocab_per_field), embed=cfg.embed_dim,
        **({"seq_len": cfg.seq_len, "blocks": cfg.n_blocks,
            "heads": cfg.n_heads} if seq else {"mlp": "-".join(
                map(str, cfg.mlp))}),
        params_gb=f"{params_gb:.3f}", dtype="float32",
        init_s=f"{time.perf_counter() - t0:.2f}")

    def serve(batch):
        step = SIDE_BULK_SLICE.get(arch, 0)
        n = next(iter(batch.values())).shape[0]
        if not step or n <= step:
            return R.serve_fn(cfg, model, batch)
        return torch.cat([R.serve_fn(cfg, model, {k: v[i:i + step]
                                                  for k, v in batch.items()})
                          for i in range(0, n, step)])

    def want_rows(batch, rows):
        if not seq:
            return 1 / (1 + np.exp(-deepfm_rows_f64(
                cfg, model, batch["sparse_ids"][rows])))
        h = seq_hidden_f64(cfg, model, batch["seq"][rows])
        cand = _f64(model.item_emb[batch["candidates"][rows].to(
            torch.int64)])
        return np.einsum("ne,nce->nc", h, cand)

    out, errs = {}, {}
    p99 = [side_batch(cfg, SERVE_P99, step, dev)
           for step in range(SIDE_P99_BATCHES + 1)]
    serve(p99[-1])                                   # first use
    p99_ms = []
    for b in p99[:-1]:
        out["serve_p99"], ms = _timed_call(lambda: serve(b))
        p99_ms.append(ms)
    rows = torch.from_numpy(_sample_rows(SERVE_P99)).to(dev)
    errs["serve_p99"] = _check_rows(f"{arch} serve_p99",
                                    out["serve_p99"][rows],
                                    want_rows(p99[-2], rows))
    t0 = time.perf_counter()
    bulk = side_batch(cfg, SERVE_BULK, 0, dev, seed=1)
    bulk_gen_s = time.perf_counter() - t0
    serve({k: v[:SIDE_BULK_SLICE.get(arch, SERVE_BULK)]
           for k, v in bulk.items()})                # first use
    out["serve_bulk"], bulk_ms = _timed_call(lambda: serve(bulk))
    rows = torch.from_numpy(_sample_rows(SERVE_BULK)).to(dev)
    errs["serve_bulk"] = _check_rows(f"{arch} serve_bulk",
                                     out["serve_bulk"][rows],
                                     want_rows(bulk, rows))
    t0 = time.perf_counter()
    if seq:
        one = side_batch(cfg, 1, 0, dev, seed=2)
        cand = {"seq": one["seq"], "candidates": torch.from_numpy(
            np.random.default_rng(3).integers(0, cfg.n_items, RETRIEVAL_CAND)
            .astype(np.int32)).to(dev)}
    else:
        cand = side_batch(cfg, RETRIEVAL_CAND, 0, dev, seed=3)
    cand_gen_s = time.perf_counter() - t0
    R.retrieval_fn(cfg, model, cand)                 # first use
    out["retrieval_cand"], cand_ms = _timed_call(
        lambda: R.retrieval_fn(cfg, model, cand))
    rows = torch.from_numpy(_sample_rows(RETRIEVAL_CAND)).to(dev)
    if seq:
        h = seq_hidden_f64(cfg, model, cand["seq"])            # (1, E)
        want = _f64(model.item_emb[cand["candidates"][rows].to(
            torch.int64)]) @ h[0]
        got = out["retrieval_cand"][0, rows]
    else:
        want = deepfm_rows_f64(cfg, model, cand["sparse_ids"][rows])
        got = out["retrieval_cand"][rows]
    errs["retrieval_cand"] = _check_rows(f"{arch} retrieval_cand", got, want)
    shapes = {"serve_p99": (SERVE_P99, SIDE_CANDIDATES) if seq
              else (SERVE_P99,),
              "serve_bulk": (SERVE_BULK, SIDE_CANDIDATES) if seq
              else (SERVE_BULK,),
              "retrieval_cand": (1, RETRIEVAL_CAND) if seq
              else (RETRIEVAL_CAND,)}
    for name, shape in shapes.items():
        if tuple(out[name].shape) != shape:
            raise AssertionError(f"{arch} {name}: shape "
                                 f"{tuple(out[name].shape)} != {shape}")

    p50, p99v = np.percentile(p99_ms, [50, 99])
    cands = SIDE_CANDIDATES if seq else 0
    say("side", arch=arch, cell="serve_p99", batch=SERVE_P99,
        batches=len(p99_ms), p50_ms=f"{p50:.4f}", p99_ms=f"{p99v:.4f}",
        samples_per_s=f"{SERVE_P99 * len(p99_ms) / (sum(p99_ms) / 1e3):.1f}",
        max_abs_err_vs_f64=f"{errs['serve_p99']:.3g}")
    _say_cost("side", f"{arch} serve_p99",
              *_recsys_cost(cfg, model, SERVE_P99, SERVE_P99 * cands), p50)
    say("side", arch=arch, cell="serve_bulk", batch=SERVE_BULK,
        rows_a_call=SIDE_BULK_SLICE.get(arch, SERVE_BULK),
        ms=f"{bulk_ms:.3f}",
        samples_per_s=f"{SERVE_BULK / (bulk_ms / 1e3):.1f}",
        batch_gen_s=f"{bulk_gen_s:.2f}",
        max_abs_err_vs_f64=f"{errs['serve_bulk']:.3g}")
    _say_cost("side", f"{arch} serve_bulk",
              *_recsys_cost(cfg, model, SERVE_BULK, SERVE_BULK * cands),
              bulk_ms)
    say("side", arch=arch, cell="retrieval_cand", candidates=RETRIEVAL_CAND,
        ms=f"{cand_ms:.3f}", batch_gen_s=f"{cand_gen_s:.2f}",
        max_abs_err_vs_f64=f"{errs['retrieval_cand']:.3g}")
    _say_cost("side", f"{arch} retrieval_cand",
              *(_recsys_cost(cfg, model, 1, RETRIEVAL_CAND) if seq else
                _recsys_cost(cfg, model, RETRIEVAL_CAND, 0)), cand_ms)
    say_profile("side", f"{arch} serve_p99", lambda: serve(p99[0]))
    one_call = {k: v[:SIDE_BULK_SLICE.get(arch, SERVE_BULK)]
                for k, v in bulk.items()}
    say_profile("side", f"{arch} serve_bulk call", lambda: serve(one_call))
    say("side", arch=arch, rows_checked=N_SIDE_CHECKED, rtol=DLRM_RTOL,
        atol=DLRM_ATOL, peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    del model, out, p99, bulk, cand, one_call
    gc.collect()
    torch.cuda.empty_cache()


# -- gin-tu ----------------------------------------------------------------


def gnn_cell(name):
    """A GNN_SHAPES cell's dims, with GNN_CELL_OVERRIDES applied."""
    from repro_torch.configs import get_config
    return dict(get_config("gin-tu").shape(name).dims,
                **GNN_CELL_OVERRIDES.get(name, {}))


def gnn_batch(name):
    """The cell's batch as numpy, and the host seconds it took:
    ``full_graph_sm`` and ``ogb_products`` a whole ``gnn_synthetic_graph``;
    ``minibatch_lg`` one ``sample_subgraph`` of 1,024 seeds (fanouts 15,
    10) over the synthetic graph's CSR, labels on the seeds only;
    ``molecule`` 128 synthetic graphs of 30 nodes and 64 edges, one label
    each.  The graph's CSR comes back for ``ogb_products`` (the aggregate
    check) and ``minibatch_lg``."""
    from repro_torch.data import (build_csr, gnn_synthetic_graph,
                                  sample_subgraph)
    d = gnn_cell(name)
    t0 = time.perf_counter()
    csr = None
    if name == "molecule":
        graphs = [gnn_synthetic_graph(d["n_nodes"], d["n_edges"], d["d_feat"],
                                      d["n_classes"], seed=g)
                  for g in range(d["batch"])]
        off = np.arange(d["batch"]) * d["n_nodes"]
        batch = {
            "x": np.concatenate([g["x"] for g in graphs]),
            "edge_src": np.concatenate([g["edge_src"] + o for g, o in
                                        zip(graphs, off)]).astype(np.int32),
            "edge_dst": np.concatenate([g["edge_dst"] + o for g, o in
                                        zip(graphs, off)]).astype(np.int32),
            "graph_id": np.repeat(np.arange(d["batch"]),
                                  d["n_nodes"]).astype(np.int32),
            "labels": np.random.default_rng(0).integers(
                0, d["n_classes"], d["batch"]).astype(np.int32)}
    else:
        g = gnn_synthetic_graph(d["n_nodes"], d["n_edges"], d["d_feat"],
                                d["n_classes"], seed=0)
        if name in ("ogb_products", "minibatch_lg"):
            csr = build_csr(g["edge_src"], g["edge_dst"], d["n_nodes"])
        if name == "minibatch_lg":
            rng = np.random.default_rng(1)
            seeds = rng.choice(d["n_nodes"], d["batch_nodes"], replace=False)
            sub = sample_subgraph(*csr, seeds, (d["fanout0"], d["fanout1"]),
                                  rng)
            mask = np.zeros(len(sub["nodes"]), np.float32)
            mask[:sub["n_seeds"]] = 1.0
            batch = {"x": g["x"][sub["nodes"]],
                     "edge_src": sub["edge_src"], "edge_dst": sub["edge_dst"],
                     "edge_mask": sub["edge_mask"],
                     "labels": g["labels"][sub["nodes"]],
                     "label_mask": mask}
        else:
            batch = g
    return batch, csr, time.perf_counter() - t0


def gin_f64(model, x, src, dst, mask=None):
    """GIN's node states recomputed in float64 numpy from the model's
    weights: a scatter-add aggregate, (1 + eps) h + agg, the MLP, ReLU and
    a LayerNorm over the population variance."""
    h = x.astype(np.float64)
    for lp in model.layers:
        p = {k: _f64(v) for k, v in lp.named_parameters()}
        msg = h[src] if mask is None else h[src] * mask[:, None]
        agg = np.zeros_like(h)
        np.add.at(agg, dst, msg)
        z = (1.0 + p["eps"]) * h + agg
        r = np.maximum(np.maximum(z @ p["w1"] + p["b1"], 0.0) @ p["w2"]
                       + p["b2"], 0.0)
        mu = r.mean(-1, keepdims=True)
        h = (r - mu) / np.sqrt(((r - mu) ** 2).mean(-1, keepdims=True)
                               + 1e-5) * p["ln"]
    return h


def _check_gin_f64(name, cfg, model, batch, tb):
    """Every logit of ``full_graph_sm`` (node) and ``molecule`` (graph)
    against a float64 numpy forward of the same weights."""
    from repro_torch.models import gnn as G
    h = G.gin_forward(cfg, model, tb["x"], tb["edge_src"], tb["edge_dst"],
                      tb.get("edge_mask"))
    hf = gin_f64(model, batch["x"], batch["edge_src"], batch["edge_dst"],
                 batch.get("edge_mask"))
    if name == "molecule":
        got = G.graph_logits(cfg, model, h, tb["graph_id"],
                             len(batch["labels"]))
        pooled = np.zeros((len(batch["labels"]), hf.shape[1]))
        np.add.at(pooled, batch["graph_id"], hf)
        hf = pooled
    else:
        got = G.node_logits(cfg, model, h)
    want = hf @ _f64(model.out) + _f64(model.out_b)
    got = _f64(got)
    err = np.abs(got - want)
    if (err > GIN_F64_ATOL + GIN_F64_RTOL * np.abs(want)).any():
        raise AssertionError(f"gin-tu {name}: logits != float64 by up to "
                             f"{err.max():.3g}")
    return float(err.max())


def _check_aggregate(x, src, dst, csr, dev):
    """The layer-1 aggregate of N_SIDE_CHECKED nodes (through the model's
    own ``_aggregate``) against float64 sums over the CSR."""
    import torch
    from repro_torch.models import gnn as G
    indptr, indices = csr
    nodes = _sample_rows(len(indptr) - 1)
    agg = G._aggregate(x, src, dst)[torch.from_numpy(nodes).to(dev)]
    xh = x.cpu().numpy()
    want = np.stack([xh[indices[indptr[v]:indptr[v + 1]]].astype(
        np.float64).sum(0) for v in nodes])
    got = _f64(agg)
    err = np.abs(got - want)
    if (err > AGG_ATOL + AGG_RTOL * np.abs(want)).any():
        raise AssertionError(f"gin-tu ogb_products: the layer-1 aggregate "
                             f"!= float64 by up to {err.max():.3g}")
    degs = np.diff(indptr)[nodes]
    return float(err.max()), int(degs.min()), int(degs.max())


def _gin_cost(cfg, batch, d_feat, n_classes):
    """(bytes, operations): the inputs read once and the weights once (the
    loss written is a scalar); the scatter-adds, products and the head.
    And the messages' floor: each layer writes and reads its (E, d_in)
    gathered messages once."""
    n, e = batch["x"].shape[0], batch["edge_src"].shape[0]
    d = cfg.d_hidden
    dims = [d_feat] + [d] * (cfg.n_layers - 1)
    weights = sum(a * d + d * d + 4 * d for a in dims) + d * n_classes
    n_bytes = sum(int(v.nbytes) for v in batch.values()) + 4 * weights
    n_ops = sum(e * a + 2 * n * (a * d + d * d) for a in dims) \
        + 2 * n * d * n_classes
    msg_bytes = sum(2 * e * a * 4 for a in dims)
    return n_bytes, n_ops, msg_bytes


def _side_gnn(dev):
    """gin-tu at each GNN_SHAPES cell; returns the host seconds spent
    building graphs.  The two large graphs are built side by side, one in
    a second thread (numpy's random fills, ``searchsorted`` and
    ``argsort`` release the interpreter lock), before any cell runs."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from repro_torch.models import gnn as G
    cfg = side_config("gin-tu")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        later = pool.submit(gnn_batch, "minibatch_lg")
        built = {"ogb_products": gnn_batch("ogb_products"),
                 "minibatch_lg": later.result()}
    host_s = time.perf_counter() - t0
    say("side", graphs_built_side_by_side="ogb_products,minibatch_lg",
        wall_s=f"{host_s:.2f}")
    for name in ("ogb_products", "minibatch_lg", "molecule",
                 "full_graph_sm"):
        d = gnn_cell(name)
        if name in built:
            batch, csr, build_s = built.pop(name)
        else:
            batch, csr, build_s = gnn_batch(name)
            host_s += build_s
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        torch.cuda.synchronize()
        h2d_s = time.perf_counter() - t0
        model = G.init_gin(cfg, torch.Generator(device=dev).manual_seed(0),
                           d["d_feat"], d["n_classes"], device=dev)
        loss_fn = G.graph_loss if name == "molecule" else G.node_loss

        def call():
            return loss_fn(cfg, model, tb)

        call()                                       # first use
        ms = []
        for _ in range(GNN_CALLS[name]):
            (loss, metrics), t = _timed_call(call)
            ms.append(t)
        loss, acc = float(loss), float(metrics["acc"])
        if not (np.isfinite(loss) and loss > 0 and 0.0 <= acc <= 1.0):
            raise AssertionError(f"gin-tu {name}: loss {loss}, acc {acc}")
        fields = {}
        if name in ("molecule", "full_graph_sm"):
            fields["max_abs_err_vs_f64"] = \
                f"{_check_gin_f64(name, cfg, model, batch, tb):.3g}"
        if name == "ogb_products":
            err, lo, hi = _check_aggregate(tb["x"], tb["edge_src"],
                                           tb["edge_dst"], csr, dev)
            fields.update(agg_max_abs_err_vs_f64=f"{err:.3g}",
                          agg_nodes=N_SIDE_CHECKED, agg_degrees=f"{lo}..{hi}")
            h1 = G.gin_forward(cfg, model, tb["x"], tb["edge_src"],
                               tb["edge_dst"])
            h2 = G.gin_forward(cfg, model, tb["x"], tb["edge_src"],
                               tb["edge_dst"])
            fields["bits_identical_across_runs"] = bool(torch.equal(h1, h2))
            fields["run_to_run_max_abs_diff"] = \
                f"{float((h1 - h2).abs().max()):.3g}"
            del h1, h2
        p50 = float(np.percentile(ms, 50))
        n_nodes, n_edges = batch["x"].shape[0], batch["edge_src"].shape[0]
        say("side", arch="gin-tu", cell=name, nodes=n_nodes, edges=n_edges,
            d_feat=d["d_feat"], classes=d["n_classes"],
            loss_fn=loss_fn.__name__, graph_build_s=f"{build_s:.2f}",
            h2d_s=f"{h2d_s:.2f}", calls=len(ms), p50_ms=f"{p50:.4f}",
            **({"graphs_per_s": f"{d['batch'] / (p50 / 1e3):.1f}"}
               if name == "molecule" else
               {"nodes_per_s": f"{n_nodes / (p50 / 1e3):.1f}"}),
            loss=f"{loss:.5f}", acc=f"{acc:.4f}",
            peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
            **fields)
        n_bytes, n_ops, msg_bytes = _gin_cost(cfg, batch, d["d_feat"],
                                              d["n_classes"])
        _say_cost("side", f"gin-tu {name}", n_bytes, n_ops, p50)
        say("side", cell=f"gin-tu {name}", message_bytes=msg_bytes,
            message_floor_ms=f"{msg_bytes / HBM_BYTES_PER_S * 1e3:.4f}")
        if name == "ogb_products":
            say_profile("side", "gin-tu ogb_products node_loss", call)
        del tb, model, batch, csr
        gc.collect()
        torch.cuda.empty_cache()
    return host_s


def _side_card_against_cpu(dev):
    """Each arch at the reference's reduced_config size, the same fp32
    weights on the card and on the CPU: serve_fn, retrieval_fn and loss_fn
    (recommenders), gin_forward with and without edge_mask, node_loss and
    graph_loss (gin-tu), within SIDE_CPU_TOL."""
    import torch
    from repro_torch.configs import get_config, replace
    from repro_torch.data import gnn_synthetic_graph, recsys_batch
    from repro_torch.models import gnn as G
    from repro_torch.models import recsys as R

    def close(what, a, b):
        a, b = a.cpu(), b.cpu()
        if not torch.allclose(a, b, rtol=SIDE_CPU_TOL, atol=SIDE_CPU_TOL):
            raise AssertionError(f"{what}: card != CPU by up to "
                                 f"{float((a - b).abs().max()):.3g}")
        return float((a - b).abs().max())

    errs = {}
    for arch in SIDE_RECSYS:
        cfg = get_config(arch)
        cfg = replace(cfg, **SIDE_REDUCED, seq_len=min(cfg.seq_len, 16))
        card = R.init_params(cfg, torch.Generator(device=dev).manual_seed(2),
                             device=dev)
        host = type(card)(cfg, device="cpu")
        host.load_state_dict(card.state_dict())
        serve = side_batch(cfg, 64, 5, "cpu")
        loss = R.as_batch(recsys_batch(cfg, 64, 6), "cpu")
        if arch == "deepfm":
            retr = side_batch(cfg, 300, 7, "cpu")
        else:
            retr = {"seq": serve["seq"][:1], "candidates": torch.arange(
                cfg.n_items + 2, dtype=torch.int32)}
        err = 0.0
        for what, fn, b in (
                ("serve_fn", R.serve_fn, serve),
                ("retrieval_fn", R.retrieval_fn, retr),
                ("loss_fn", lambda c, m, x: R.loss_fn(c, m, x)[0], loss)):
            err = max(err, close(f"{arch} {what}",
                                 fn(cfg, card, {k: v.to(dev) for k, v in
                                                b.items()}),
                                 fn(cfg, host, b)))
        errs[arch] = err
    cfg = side_config("gin-tu")
    g = gnn_synthetic_graph(512, 2048, 32, 8, seed=0)
    g["edge_mask"] = (np.arange(2048) % 4 != 3).astype(np.float32)
    card = G.init_gin(cfg, torch.Generator(device=dev).manual_seed(3), 32, 8,
                      device=dev)
    host = G.GIN(cfg, 32, 8, device="cpu")
    host.load_state_dict(card.state_dict())
    tb = {k: torch.from_numpy(v) for k, v in g.items()}
    cb = {k: v.to(dev) for k, v in tb.items()}
    err = 0.0
    for mask in (None, "edge_mask"):
        err = max(err, close(f"gin-tu gin_forward edge_mask={mask}",
                             G.gin_forward(cfg, card, cb["x"], cb["edge_src"],
                                           cb["edge_dst"], cb.get(mask)),
                             G.gin_forward(cfg, host, tb["x"], tb["edge_src"],
                                           tb["edge_dst"], tb.get(mask))))
    tb["graph_id"] = torch.arange(512, dtype=torch.int32) // 64
    tb["labels_g"] = torch.arange(8, dtype=torch.int32) % 8
    cb = {k: v.to(dev) for k, v in tb.items()}
    for fn, pick in ((G.node_loss, lambda b: b),
                     (G.graph_loss, lambda b: dict(b, labels=b["labels_g"]))):
        (lc, mc), (lh, mh) = fn(cfg, card, pick(cb)), fn(cfg, host, pick(tb))
        err = max(err, close(f"gin-tu {fn.__name__}", lc, lh))
        n = float(pick(tb)["labels"].shape[0])
        if abs(float(mc["acc"]) - float(mh["acc"])) * n > 1.0 + 1e-6:
            raise AssertionError(f"gin-tu {fn.__name__}: accuracy "
                                 f"{float(mc['acc'])} != {float(mh['acc'])}")
    errs["gin-tu"] = err
    say("side", card_vs_cpu=json.dumps({k: float(f"{v:.3g}")
                                        for k, v in errs.items()}),
        tol=SIDE_CPU_TOL, sizes="reduced_config")


@serving
def phase_side(dev):
    """DeepFM, SASRec and BERT4Rec at their serving cells and gin-tu at
    every GNN_SHAPES cell, at full width; each held against float64, then
    the card against the CPU at reduced size.  None of the five kernels is
    on these paths, so no launch count moves."""
    import torch
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    say("side", start_allocated_gb=
        f"{torch.cuda.memory_allocated() / 1e9:.3f}",
        tf32=torch.backends.cuda.matmul.allow_tf32,
        matmul_precision=torch.get_float32_matmul_precision())
    before = dict(ops.LAUNCHES)
    for arch in SIDE_RECSYS:
        _side_recsys(dev, arch)
    host_s = _side_gnn(dev)
    _side_card_against_cpu(dev)
    if ops.LAUNCHES != before:
        raise AssertionError(f"the side phase launched kernels: {before} -> "
                             f"{ops.LAUNCHES}")
    secs = time.perf_counter() - t0
    say("side", kernel_launches_moved=False, seconds=f"{secs:.1f}",
        host_graph_build_s=f"{host_s:.1f}",
        rest_s=f"{secs - host_s:.1f}")


# ---------------------------------------------------------------------------
# phase 15: training
# ---------------------------------------------------------------------------

# dlrm-rm2 trained at full size at RECSYS_SHAPES' train cell: run 1 takes
# DLRM_TRAIN_STEPS steps and saves, run 2 resumes to twice as many, run 3
# takes them uninterrupted
DLRM_TRAIN_BATCH = 65_536
DLRM_TRAIN_STEPS = 10
DLRM_TIMED_STEPS = 10          # steps timed one by one after the runs
DLRM_GATE_ROWS = 64            # table rows of each kind held to float64 AdamW
DOT_GRAD_SAMPLES = 4_096       # kernel 4's backward against float64 on these
DOT_GRAD_TOL = 1e-5            # of the float64 gradient's largest entry
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 1e-4, 1e-6    # kernel 4 against plain
RESUME_RTOL, RESUME_ATOL = 1e-5, 1e-6
# AdamW's update of sampled rows against float64: p within ADAMW_ATOL, the
# moments within ADAMW_M_ATOL of their largest sampled entry
ADAMW_RTOL, ADAMW_ATOL, ADAMW_M_ATOL = 1e-5, 1e-7, 1e-6
# llama3-8b at full width, cut to LM_TRAIN_LAYERS of its 32 layers: AdamW's
# fp32 state of the whole model (8.03 B parameters x 16 bytes) is 128 GB
LM_TRAIN_LAYERS, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 2, 4, 1024, 5
LM_TRAIN_OVERRIDES = {}        # config fields (none: the published widths)
LM_REMAT_RTOL, LM_REMAT_ATOL = 1e-5, 1e-9
# every arch but cooccur-csl at the reference's reduced_config, on the card
# and on the CPU from one step-0 checkpoint
TRAIN_ARCHS = None             # None: all of them
TRAIN_ARCH_STEPS = 3
TRAIN_CPU_TOL = 1e-4


def _timed_each(module, name, times):
    """Wrap ``module.name`` so that each call appends its host seconds
    (ending in a synchronize) to ``times``; returns the undo."""
    import torch
    fn = getattr(module, name)

    def timed(*args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    setattr(module, name, timed)
    return lambda: setattr(module, name, fn)


def _dlrm_train_runs(dev, cfg, state_bytes):
    """Runs 1-3 through ``train(reduce=False)``: the resumed run's last
    loss == the uninterrupted run's; kernel 4 launched once a step."""
    import shutil
    from repro_torch.kernels import ops
    from repro_torch.launch import train as TL
    from repro_torch.train import checkpoint
    n = DLRM_TRAIN_STEPS
    d = _snapshot_dir(2 * state_bytes, prefix="dlrm-train-")
    saves, restores = [], []
    undo = [_timed_each(checkpoint, "save", saves),
            _timed_each(checkpoint, "restore", restores)]
    before = ops.LAUNCHES["dot_interaction"]
    t0 = time.perf_counter()
    try:
        kw = dict(batch=DLRM_TRAIN_BATCH, reduce=False, device=dev,
                  log_every=n)
        r1 = TL.train(cfg.name, steps=n, ckpt_dir=d, ckpt_every=10 ** 9,
                      **kw)
        ckpt_gb = sum(f.stat().st_size for f in Path(d).rglob("*")
                      if f.is_file()) / 1e9
        r2 = TL.train(cfg.name, steps=2 * n, ckpt_dir=d, ckpt_every=10 ** 9,
                      **kw)
        r3 = TL.train(cfg.name, steps=2 * n, **kw)
    finally:
        for u in undo:
            u()
        shutil.rmtree(d, ignore_errors=True)
    secs = time.perf_counter() - t0
    launches = ops.LAUNCHES["dot_interaction"] - before
    if launches != 4 * n:
        raise AssertionError(f"dlrm train: kernel 4 launched {launches} "
                             f"times in {4 * n} forward passes")
    if not np.isclose(r2["loss"], r3["loss"], rtol=RESUME_RTOL,
                      atol=RESUME_ATOL) or not np.isfinite(r1["loss"]):
        raise AssertionError(f"dlrm train: resumed loss {r2['loss']!r} != "
                             f"uninterrupted {r3['loss']!r}")
    if len(saves) != 2 or len(restores) != 1:
        raise AssertionError(f"dlrm train: {len(saves)} saves, "
                             f"{len(restores)} restores")
    say("train", arch=cfg.name, runs=f"{n},resume-to-{2 * n},{2 * n}",
        batch=DLRM_TRAIN_BATCH, loss_run1=repr(r1["loss"]),
        loss_resumed=repr(r2["loss"]), loss_uninterrupted=repr(r3["loss"]),
        resume_equal=True, rtol=RESUME_RTOL, dot_launches=launches,
        forward_passes=4 * n, save_s=" ".join(f"{t:.2f}" for t in saves),
        restore_s=f"{restores[0]:.2f}", checkpoint_gb=f"{ckpt_gb:.3f}",
        seconds=f"{secs:.1f}")


def _check_kernel_grads(cfg, model, loss_fn, batch):
    """One full-size step's gradients through kernel 4 == through its plain
    version on the same device, and kernel 4 launched once."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.train.step import loss_and_grads
    before = ops.LAUNCHES["dot_interaction"]
    _, _, g_kernel = loss_and_grads(loss_fn, model, batch)
    real = ops._dot_interaction_forward
    ops._dot_interaction_forward = ref.dot_interaction_ref
    try:
        _, _, g_plain = loss_and_grads(loss_fn, model, batch)
    finally:
        ops._dot_interaction_forward = real
    if ops.LAUNCHES["dot_interaction"] - before != 1:
        raise AssertionError("dlrm train: the gradient pair launched kernel 4 "
                             f"{ops.LAUNCHES['dot_interaction'] - before} "
                             "times")
    err = 0.0
    for name, g in g_plain.items():
        err = max(err, float((g_kernel[name] - g).abs().max()))
        if not torch.allclose(g_kernel[name], g, rtol=TRAIN_GRAD_RTOL,
                              atol=TRAIN_GRAD_ATOL):
            raise AssertionError(f"dlrm train: {name}'s gradient through "
                                 "kernel 4 != through the plain version")
    return err, g_kernel


def _check_dot_backward(dev, cfg, model, batch):
    """Kernel 4's backward (plain PyTorch on the card) on DOT_GRAD_SAMPLES
    samples of the step's interaction input against float64 on the CPU,
    then timed at the full batch beside its bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.models import recsys as R
    with torch.no_grad():
        _, x = R.interaction_input(cfg, model, batch)
    b, f, e = x.shape
    p = f * (f - 1) // 2
    gen = torch.Generator(device=dev).manual_seed(3)
    g = torch.randn((b, p), generator=gen, device=dev)
    s = min(DOT_GRAD_SAMPLES, b)
    got = ref.dot_interaction_grad_ref(x[:s], g[:s]).cpu().double()
    want = ref.dot_interaction_grad_ref(x[:s].cpu().double(),
                                        g[:s].cpu().double())
    err = float((got - want).abs().max() / want.abs().max())
    if not err <= DOT_GRAD_TOL:
        raise AssertionError(f"kernel 4 backward != float64: max |diff| / "
                             f"max |dX| = {err:.3g} > {DOT_GRAD_TOL}")
    ms = cuda_ms(lambda: ref.dot_interaction_grad_ref(x, g), 5)
    n_bytes = 2 * b * f * e * 4 + b * p * 4
    n_ops = 2 * b * f * f * e
    bound_ms, bound_by = _bound_ms(n_bytes, n_ops, FP32_OPS_PER_S)
    say("train", kernel="dot_interaction_backward", route="plain-pytorch",
        samples_checked=s, max_rel_err_vs_f64=f"{err:.3g}",
        tol=DOT_GRAD_TOL, batch=b, fields=f, embed=e, ms=f"{ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, bytes=n_bytes,
        flops=n_ops)
    return {"ms": ms, "bound_ms": bound_ms, "max_rel_err": err}


def _adamw_rows_f64(cfg, before, grads, gn, count):
    """The reference's AdamW on sampled rows in float64 (clip by the global
    norm, the schedule at ``count + 1``): (p, m, v)."""
    import math
    c = count + 1
    warm = min(c / max(cfg.warmup_steps, 1), 1.0)
    t = min(max((c - cfg.warmup_steps) / 10000.0, 0.0), 1.0)
    lr = cfg.learning_rate * warm * (0.55 + 0.45 * math.cos(math.pi * t))
    scale = min(1.0, cfg.grad_clip / max(gn, 1e-9)) if cfg.grad_clip > 0 \
        else 1.0
    b1, b2, eps = 0.9, 0.95, 1e-8
    p, m, v = before
    g = grads * scale
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    step = (m / (1 - b1 ** c)) / (np.sqrt(v / (1 - b2 ** c)) + eps)
    return p - lr * (step + cfg.weight_decay * p), m, v


def _check_adamw_rows(cfg, model, opt, st, loss_fn, batch):
    """One update at full size held to float64 on DLRM_GATE_ROWS table
    rows the batch touches and as many it does not (their gradient is 0,
    but their moments decay and their weights move): the dense update of
    the reference, not a sparse-row one, and its schedule and clip, not
    ``torch.optim.AdamW``'s."""
    import torch
    from repro_torch.models import recsys as R
    from repro_torch.train.step import apply_update, loss_and_grads
    _, _, grads = loss_and_grads(loss_fn, model, batch)
    gn = float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                              for g in grads.values())))
    touched = torch.zeros(model.table.shape[0], dtype=torch.bool,
                          device=model.table.device)
    touched[R._flat_field_ids(cfg, batch["sparse_ids"]).reshape(-1)] = True
    seen = (st["m"]["table"] != 0).any(dim=1)
    rows = []
    for want in (touched & seen, ~touched & seen):
        idx = torch.nonzero(want)[:, 0]
        if idx.numel() < DLRM_GATE_ROWS:
            raise AssertionError("dlrm train: too few rows for the AdamW "
                                 "gate")
        pick = torch.linspace(0, idx.numel() - 1, DLRM_GATE_ROWS).long()
        rows.append(idx[pick.to(idx.device)])
    rows = torch.cat(rows)

    def host(t):
        return t[rows].detach().double().cpu().numpy()

    before = (host(model.table), host(st["m"]["table"]),
              host(st["v"]["table"]))
    want = _adamw_rows_f64(cfg, before, host(grads["table"]), gn,
                           int(st["count"]))
    st, stats = apply_update(opt, model, st, grads)
    got = (host(model.table), host(st["m"]["table"]),
           host(st["v"]["table"]))
    for name, a, w in zip(("p", "m", "v"), got, want):
        # the moments may cancel to near 0: their atol scales with them
        atol = ADAMW_ATOL if name == "p" else ADAMW_M_ATOL * np.abs(w).max()
        if not np.allclose(a, w, rtol=ADAMW_RTOL, atol=atol):
            raise AssertionError(
                f"dlrm train: AdamW's {name} != the reference's in float64 "
                f"on sampled rows (max |diff| {np.abs(a - w).max():.3g})")
    moved = np.abs(got[0][DLRM_GATE_ROWS:] - before[0][DLRM_GATE_ROWS:]
                   ).max()
    return st, float(moved)


def _dlrm_train_timed(dev, cfg):
    """The gradient gates, then DLRM_TIMED_STEPS steps timed one by one,
    one profiled, and AdamW held to float64 on sampled rows."""
    import torch
    from repro_torch import pytree
    from repro_torch.kernels import ops
    from repro_torch.launch import train as TL
    from repro_torch.train import make_optimizer, make_train_step
    model = TL.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    loss_fn = TL.make_loss(cfg)
    batch_fn = TL.make_batch_fn(cfg, DLRM_TRAIN_BATCH, 0, dev)
    grad_err, g = _check_kernel_grads(cfg, model, loss_fn, batch_fn(0))
    del g
    backward = _check_dot_backward(dev, cfg, model, batch_fn(0))
    opt = make_optimizer(cfg)
    st = opt.init(pytree.module_tree(model))
    step = make_train_step(cfg, loss_fn, opt)
    state = {"model": model, "st": st}

    def run(s):
        b = batch_fn(s)
        state["model"], state["st"], m = step(state["model"], state["st"], b)
        return m

    run(1)                                   # first use: allocator
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = ops.LAUNCHES["dot_interaction"]
    ms = []
    for s in range(2, 2 + DLRM_TIMED_STEPS):
        ms.append(_timed_call(lambda: float(run(s)["loss"]))[1])
    peak = torch.cuda.max_memory_allocated()
    launches = ops.LAUNCHES["dot_interaction"] - before
    if launches != DLRM_TIMED_STEPS:
        raise AssertionError(f"dlrm train: {launches} kernel 4 launches in "
                             f"{DLRM_TIMED_STEPS} steps")
    n_params = sum(p.numel() for p in model.parameters())
    pb = n_params * 4
    floor_bytes = 7 * pb          # read p, g, m, v; write p, m, v
    grad_bytes = 4 * pb           # zero-fill, norm, clip read + write
    p50, p99 = np.percentile(ms, [50, 99])
    say("train", arch=cfg.name, cell="train", batch=DLRM_TRAIN_BATCH,
        params=n_params, steps_timed=len(ms), step_ms_p50=f"{p50:.3f}",
        step_ms_p99=f"{p99:.3f}",
        samples_per_s=f"{DLRM_TRAIN_BATCH * len(ms) / (sum(ms) / 1e3):.1f}",
        peak_gb=f"{peak / 1e9:.3f}",
        bytes_floor=floor_bytes,
        bound_ms=f"{floor_bytes / HBM_BYTES_PER_S * 1e3:.3f}",
        bytes_with_grad_passes=floor_bytes + grad_bytes,
        bound_with_grad_passes_ms=
        f"{(floor_bytes + grad_bytes) / HBM_BYTES_PER_S * 1e3:.3f}",
        grad_kernel_vs_plain_max_abs=f"{grad_err:.3g}",
        grad_rtol=TRAIN_GRAD_RTOL, grad_atol=TRAIN_GRAD_ATOL)
    prof = device_profile(lambda: run(99), top=12)
    if prof is None:
        say("train", profile="dlrm-rm2 step", device_busy_ms="not-measured")
    else:
        wall_ms, busy, kernels = prof
        say("train", profile="dlrm-rm2 step", wall_ms=f"{wall_ms:.4f}",
            device_busy_ms=f"{busy:.4f}",
            idle_share=f"{max(0.0, 1 - busy / wall_ms):.3f}",
            top_kernels=json.dumps(kernels))
    st, moved = _check_adamw_rows(cfg, state["model"], opt, state["st"],
                                  loss_fn, batch_fn(100))
    say("train", adamw_vs_f64_rows=2 * DLRM_GATE_ROWS, rtol=ADAMW_RTOL,
        atol=ADAMW_ATOL, untouched_rows_moved=f"{moved:.3g}")
    del state, st, model, opt
    return {"step_ms_p50": p50, "backward": backward}


def _lm_train(dev):
    """llama3-8b at full width, LM_TRAIN_LAYERS layers, fp32 weights and
    AdamW moments: a step's loss and gradients with remat on and off, then
    LM_TRAIN_STEPS timed steps."""
    import torch
    from repro_torch import pytree
    from repro_torch.configs import get_config, replace
    from repro_torch.launch import train as TL
    from repro_torch.models import transformer as T
    from repro_torch.train import make_optimizer, make_train_step
    from repro_torch.train.step import loss_and_grads
    cfg = replace(get_config("llama3-8b"),
                  **{"n_layers": LM_TRAIN_LAYERS, **LM_TRAIN_OVERRIDES})
    gc.collect()
    torch.cuda.empty_cache()
    model = TL.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    batch_fn = TL.make_batch_fn(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, dev)
    b0 = batch_fn(0)
    runs = {}
    for remat in (True, False):
        c = replace(cfg, remat=remat)
        runs[remat] = loss_and_grads(lambda m, b: T.loss_fn(c, m, b), model,
                                     b0)
    (l_on, _, g_on), (l_off, _, g_off) = runs[True], runs[False]
    if not np.isclose(float(l_on), float(l_off), rtol=LM_REMAT_RTOL,
                      atol=0):
        raise AssertionError(f"lm train: remat loss {float(l_on)!r} != "
                             f"{float(l_off)!r}")
    for name, g in g_off.items():
        if not torch.allclose(g_on[name], g, rtol=LM_REMAT_RTOL,
                              atol=LM_REMAT_ATOL):
            raise AssertionError(f"lm train: {name}'s gradient with remat "
                                 "!= without")
    del runs, g_on, g_off
    opt = make_optimizer(cfg)
    st = opt.init(pytree.module_tree(model))
    step = make_train_step(cfg, TL.make_loss(cfg), opt)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for s in range(LM_TRAIN_STEPS):
        b = batch_fn(s)
        (model, st, m), t = _timed_call(lambda: step(model, st, b))
        losses.append(float(m["loss"]))
        ms.append(t)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"lm train: losses {losses}")
    n_params = sum(p.numel() for p in model.parameters())
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    n_ops = 6 * n_params * tokens
    bound_ms = n_ops / FP32_OPS_PER_S * 1e3
    steady = ms[1:] or ms
    med = float(np.median(steady))
    say("train", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, params=n_params, batch=LM_TRAIN_BATCH,
        seq=LM_TRAIN_SEQ, remat=cfg.remat, remat_gate=True,
        rtol=LM_REMAT_RTOL, steps=LM_TRAIN_STEPS,
        step_ms=" ".join(f"{t:.1f}" for t in ms), step_ms_median=f"{med:.1f}",
        tokens_per_s=f"{tokens / (med / 1e3):.1f}",
        peak_gb=f"{peak / 1e9:.3f}", flops_6nd=n_ops,
        bound_ms=f"{bound_ms:.1f}", bound_by="operations",
        loss_first=f"{losses[0]:.4f}", loss_last=f"{losses[-1]:.4f}")
    del model, st, opt, step
    gc.collect()
    torch.cuda.empty_cache()


def _train_card_against_cpu(dev):
    """Each arch at the reference's reduced_config through ``train()`` on
    the card and on the CPU, both resuming one step-0 checkpoint of
    CPU-drawn weights: the losses and the step-3 weights agree.  (The bf16
    moments of qwen and kimi may round a last-bit difference to the
    neighbouring bf16 value, so the state is not held to 1e-4.)"""
    import shutil
    import tempfile
    import torch
    from repro_torch import pytree
    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch import train as TL
    from repro_torch.train import checkpoint, make_optimizer
    archs = TRAIN_ARCHS or [a for a in list_archs() if a != "cooccur-csl"]
    out = {}
    for arch in archs:
        cfg = TL.reduced_config(get_config(arch))
        model = TL.init_params(cfg, torch.Generator().manual_seed(1),
                               device="cpu")
        params = pytree.module_tree(model)
        tmpl = (params, make_optimizer(cfg).init(params))
        d = tempfile.mkdtemp(prefix="train-cpu-")
        try:
            for where in ("card", "cpu"):
                checkpoint.save(f"{d}/{where}", 0, tmpl)
            r_card = TL.train(arch, steps=TRAIN_ARCH_STEPS,
                              ckpt_dir=f"{d}/card", device=dev,
                              log_every=100)
            r_cpu = TL.train(arch, steps=TRAIN_ARCH_STEPS,
                             ckpt_dir=f"{d}/cpu", device="cpu",
                             log_every=100)
            (card, _), _ = checkpoint.restore(f"{d}/card", tmpl,
                                              device="cpu")
            (host, _), _ = checkpoint.restore(f"{d}/cpu", tmpl, device="cpu")
        finally:
            shutil.rmtree(d, ignore_errors=True)
        if not np.isclose(r_card["loss"], r_cpu["loss"], rtol=TRAIN_CPU_TOL,
                          atol=TRAIN_CPU_TOL):
            raise AssertionError(f"{arch}: card loss {r_card['loss']!r} != "
                                 f"CPU loss {r_cpu['loss']!r}")
        err = 0.0
        for (path, a), (_, w) in zip(pytree.flatten_with_path(card),
                                     pytree.flatten_with_path(host)):
            a, w = a.double(), w.double()
            if not torch.allclose(a, w, rtol=TRAIN_CPU_TOL,
                                  atol=TRAIN_CPU_TOL):
                raise AssertionError(f"{arch}: card {pytree.keystr(path)} "
                                     "!= CPU after training")
            err = max(err, float((a - w).abs().max()))
        out[arch] = {"loss_card": round(r_card["loss"], 6),
                     "loss_cpu": round(r_cpu["loss"], 6),
                     "max_abs_diff": float(f"{err:.3g}")}
    say("train", card_vs_cpu=json.dumps(out), steps=TRAIN_ARCH_STEPS,
        tol=TRAIN_CPU_TOL)


def phase_train(dev):
    """Training: dlrm-rm2 at full size through ``train()`` (resume and
    checkpoints), kernel 4 under autograd against its plain version, its
    backward against float64, AdamW against float64; llama3-8b at full
    width and LM_TRAIN_LAYERS layers; every arch on the card against the
    CPU at reduced size.  Returns kernel 4's launches in this phase."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as TL
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = TL.get_config("dlrm-rm2")
    f, v, e = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
    state_bytes = 3 * 4 * f * v * e          # p, m, v of the table
    ops.reset_launches()
    say("train", start_allocated_gb=
        f"{torch.cuda.memory_allocated() / 1e9:.3f}",
        tf32=torch.backends.cuda.matmul.allow_tf32,
        matmul_precision=torch.get_float32_matmul_precision(),
        dlrm_rows_per_field=v, dlrm_state_gb=f"{state_bytes / 1e9:.3f}")
    _dlrm_train_runs(dev, cfg, state_bytes)
    gc.collect()
    torch.cuda.empty_cache()
    timed = _dlrm_train_timed(dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    _lm_train(dev)
    _train_card_against_cpu(dev)
    launches = ops.LAUNCHES["dot_interaction"]
    if launches == 0:
        raise AssertionError("the train phase never launched kernel 4")
    say("train", dot_interaction_launches=launches,
        seconds=f"{time.perf_counter() - t0:.1f}")
    return {"launches": launches, **timed}


# ---------------------------------------------------------------------------
# phase 16: the launch layer
# ---------------------------------------------------------------------------

# the dry-run's placeholder sweep in the reference's scan mode, then the
# cells that fit run on the card; the co-occurrence query and ingest cells
# run again under each of these methods (kernels 2 and 1), beside "gemm"
LAUNCH_MODE = "scan"
LAUNCH_METHODS = ("fused", "pallas")
LAUNCH_CELLS = None            # None: every cell of all_cells()
LAUNCH_SUBPROCESS = True       # each cell planned in its own process
# the cells that must end "ok" on the placeholder meshes: all but cooccur
LAUNCH_MUST_PLAN = ("lm", "recsys", "gnn")


def _launch_family(arch):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import CoocConfig, GNNConfig, LMConfig
    cfg = get_config(arch)
    return ("lm" if isinstance(cfg, LMConfig) else
            "gnn" if isinstance(cfg, GNNConfig) else
            "cooc" if isinstance(cfg, CoocConfig) else "recsys")


def _launch_read(out_dir, arch, shape, mesh):
    from repro_torch.launch import dryrun as DR
    with open(DR.record_path(out_dir, arch, shape, mesh, LAUNCH_MODE)) as f:
        return json.load(f)


def _say_plan(recs):
    """One line for a cell's records on the placeholder meshes."""
    from repro_torch.launch import dryrun as DR
    first = recs[0]
    planned = DR.planned_peak(first)
    fields = dict(cell=f"{first['arch']}/{first['shape']}",
                  status=first["status"],
                  program_peak_gb=f"{first['counts']['peak_bytes'] / 1e9:.3f}",
                  planned_peak_gb="none" if planned is None else
                  f"{planned / 1e9:.3f}")
    for rec in recs:
        m = rec["mesh"]
        fields[f"args_gb_per_device_{m}"] = \
            f"{rec['memory']['argument_size_in_bytes'] / 1e9:.3f}"
        if rec["status"] == "ok":
            rl = rec["roofline"]
            fields[f"flops_per_dev_{m}"] = f"{rl['flops_per_dev']:.4e}"
            fields[f"kernel_ops_per_dev_{m}"] = \
                f"{rl['kernel_ops_per_dev']:.4e}"
            fields[f"bytes_per_dev_{m}"] = f"{rl['hbm_bytes_per_dev']:.4e}"
    if first["status"] == "ok":
        rl = first["roofline"]
        fields.update(coll_bytes_per_dev=rl["coll_bytes_per_dev"],
                      bottleneck=rl["bottleneck"],
                      useful_ratio=f"{rl['useful_ratio']:.4f}")
    else:
        fields["reason"] = repr(first["reason"])
    say("launch", **fields)


def _say_host(rec, **extra):
    fields = dict(cell=f"{rec['arch']}/{rec['shape']}", mesh=rec["mesh"],
                  status=rec["status"])
    if rec["status"] != "ok":
        fields["reason"] = repr(rec["reason"])
        say("launch", **fields)
        return
    rl, mem = rec["roofline"], rec["memory"]
    t_model = max(rl["model_flops"] / (rl["n_chips"] * BF16_OPS_PER_S),
                  rl["model_bytes"] / (rl["n_chips"] * HBM_BYTES_PER_S))
    fields.update(
        t_step_ms=f"{rec['t_step_s'] * 1e3:.3f}",
        peak_gb=f"{mem.get('peak_per_device_bytes', 0) / 1e9:.3f}",
        planned_peak_gb=f"{rec['planned_peak_bytes'] / 1e9:.3f}",
        args_gb=f"{mem['argument_size_in_bytes'] / 1e9:.3f}",
        flops=rec["counts"]["flops"], meta_flops=rec["meta_flops"],
        kernel_ops=rec["counts"]["kernel_ops"],
        t_kernel_ops_ms=f"{rl['t_kernel_ops_s'] * 1e3:.4f}",
        bytes=rec["counts"]["bytes"],
        bottleneck=rl["bottleneck"],
        roofline_fraction=f"{rl['roofline_fraction']:.4f}",
        t_model_ms=f"{t_model * 1e3:.4f}",
        t_model_over_step=f"{t_model / rec['t_step_s']:.4g}",
        kernels=json.dumps(rec["counts"]["kernels"]), **extra)
    if "postings_density" in rec:
        fields["postings_density"] = f"{rec['postings_density']:.4e}"
    say("launch", **fields)


def phase_launch(dev):
    """The launch layer (``repro_torch.launch.dryrun``): every cell planned
    on the 16x16 and 2x16x16 placeholder meshes (``meta``), counted once
    on a one-device ``meta`` mesh; then each cell whose planned peak fits
    run on the card at full size from seeded inputs, the co-occurrence
    index from the CSL corpus model (FLOPs and kernel counts == the meta
    count, the peak within the fit rule's reserve of the planned one,
    model FLOPs and bytes == the plan's, outputs finite), and the
    co-occurrence query and ingest cells under LAUNCH_METHODS == under
    "gemm".  Returns the phase's kernel launches."""
    import os
    import shutil
    import tempfile
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.cells import all_cells
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cells = list(LAUNCH_CELLS or all_cells())
    card = smi("name,power.limit")
    say("launch", card=repr(card), cells=len(cells), mode=LAUNCH_MODE,
        jobs=DR.JOBS if LAUNCH_SUBPROCESS else 1)
    out_dir = tempfile.mkdtemp(prefix="dryrun-torch-")
    try:
        rc = DR.run_all([False, True], out_dir, LAUNCH_MODE,
                        subprocess_mode=LAUNCH_SUBPROCESS, verbose=False,
                        cells=cells)
        t_plan = time.perf_counter() - t0
        for arch, shape in cells:
            recs = [_launch_read(out_dir, arch, shape, mesh)
                    for mesh in ("16x16", "2x16x16")]
            _say_plan(recs)
            for rec in recs:
                if rec["status"] != "ok" and \
                        _launch_family(arch) in LAUNCH_MUST_PLAN:
                    raise AssertionError(f"{arch} x {shape} @ {rec['mesh']} "
                                         f"ended {rec['status']}")
        if rc:
            raise AssertionError("the placeholder sweep failed")
        say("launch", placeholder_sweep_s=f"{t_plan:.1f}")

        ops.reset_launches()
        n_run = 0
        for arch, shape in cells:
            meta = _launch_read(out_dir, arch, shape, "meta-1x1")
            kind = meta["kind"]
            again = kind in ("cooc_query", "cooc_ingest")
            rec, out = DR.host_cell(arch, shape, meta, device=dev,
                                    mode=LAUNCH_MODE, out_dir=out_dir,
                                    verbose=False, keep_output=again)
            _say_host(rec)
            n_run += rec["status"] == "ok"
            if again and rec["status"] == "ok":
                for method in LAUNCH_METHODS:
                    os.environ["REPRO_COOC_METHOD"] = method
                    try:
                        meta_m, = DR.plan_records(arch, shape, (), None,
                                                  LAUNCH_MODE, verbose=False)
                        rec_m, out_m = DR.host_cell(
                            arch, shape, meta_m, device=dev,
                            mode=LAUNCH_MODE, out_dir=out_dir,
                            verbose=False, keep_output=True)
                    finally:
                        del os.environ["REPRO_COOC_METHOD"]
                    if rec_m["status"] != "ok" or not same_network(out,
                                                                   out_m):
                        raise AssertionError(f"{arch} x {shape}: {method}'s "
                                             "answer != gemm's")
                    _say_host(rec_m, equal_to_gemm=True)
                    del out_m
            del out
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    launches = dict(ops.LAUNCHES)
    for name in ("postings_counts", "level_step", "dot_interaction"):
        if launches[name] == 0:
            raise AssertionError(f"phase launch never launched {name}")
    say("launch", cells_run=n_run, launches=json.dumps(launches),
        card=repr(card), seconds=f"{time.perf_counter() - t0:.1f}")
    return launches


# ids out of range, answered as the reference answers them: a CSL-shaped
# corpus (the reference's serve_realtime example: 4,000 docs over 1,024
# terms), its lane batch of IDS_SEEDS_PER_METHOD requests a method with
# seeds V and V + 3 among them; llama3-8b at full width and IDS_LM_LAYERS
# layers, bf16, IDS_LM_PROMPTS prompts through IDS_LM_SLOTS slots; the
# recommenders at the reference's reduced tables (1,000 rows a field or
# items) and IDS_BATCH samples, the same weights on the CPU; GIN over a
# synthetic graph of IDS_GIN (nodes, edges)
IDS_DOCS, IDS_TERMS = 4000, 1024
IDS_PLAN = dict(depth=2, topk=8, beam=16)
IDS_LM_LAYERS, IDS_LM_SLOTS, IDS_LM_PROMPTS, IDS_LM_NEW = 2, 4, 5, 8
IDS_GRAD_TOKENS = 1 << 18               # above llama3-8b's 128,256 rows
IDS_BATCH, IDS_CANDIDATES = 16_384, 100
IDS_GIN = (4096, 32_768)
IDS_CPU_TOL = 1e-4


def _ids_slots(net):
    import torch
    return np.stack([np.asarray(a.cpu() if isinstance(a, torch.Tensor)
                                else a).astype(np.int64)
                     for a in (net.src, net.dst, net.weight, net.valid)])


def _ids_cooc(dev):
    """A CoocServer lane on the card, unsharded and on a term mesh of
    MESH_SHARDS shards of it, takes one batch of requests under all four
    methods that mixes seeds V and V + 3 with good ones, then a later
    query: every response ok and equal to ``construct`` on the CPU."""
    import asyncio
    import torch
    from repro_torch.core import (QueryContext, QuerySpec, construct,
                                  make_cooc_mesh)
    from repro_torch.data import synthetic_csl
    from repro_torch.serve import (AdmissionPolicy, CoocServer, ServerConfig,
                                   TenantConfig)
    docs = synthetic_csl(IDS_DOCS, IDS_TERMS, seed=0)
    v = IDS_TERMS
    host = QueryContext.from_docs(docs, v, device="cpu")
    df = host.index.doc_freq.numpy()
    hot = [int(t) for t in np.argsort(-df, kind="stable")[:4]]
    seeds = [(hot[0],), (v,), (v + 3,), (hot[1], v), (hot[2],)]
    reqs = [(m, s) for m in ("gemm", "popcount", "pallas", "fused")
            for s in seeds]
    want = {(m, s): _ids_slots(construct(host, QuerySpec(
        seeds=s, method=m, **IDS_PLAN)).network) for m, s in reqs}
    later_want = _ids_slots(construct(host, QuerySpec(
        seeds=(hot[3],), **IDS_PLAN)).network)
    for mesh in (None, "terms"):
        kw = {} if mesh is None else dict(mesh=make_cooc_mesh(
            devices=[dev] * MESH_SHARDS, shard=mesh))
        ctx = QueryContext.from_docs(docs, v, device=dev, **kw)

        async def go():
            server = CoocServer(ctx, tenants=[TenantConfig("t")],
                                config=ServerConfig(
                                    q_batch=8, linger_ms=20.0,
                                    default_deadline_ms=120_000.0,
                                    policy=AdmissionPolicy(
                                        max_queue_depth=64,
                                        max_wait_ms=120_000.0),
                                    **IDS_PLAN))
            await server.start()
            try:
                first = await asyncio.wait_for(asyncio.gather(*[
                    server.submit("t", dict(seeds=list(s), method=m))
                    for m, s in reqs]), 300.0)
                torch.cuda.synchronize()
                later = await asyncio.wait_for(
                    server.submit("t", [hot[3]]), 300.0)
                torch.cuda.synchronize()
            finally:
                await server.stop()
            return first, later

        first, later = asyncio.run(go())
        for (m, s), resp in zip(reqs, first):
            if not resp.ok:
                raise AssertionError(f"ids: {m} {s} on {mesh or 'one'} "
                                     f"device: {resp.status} {resp.reason}")
            if not np.array_equal(_ids_slots(resp.result.network),
                                  want[m, s]):
                raise AssertionError(f"ids: {m} {s} on {mesh or 'one'} "
                                     "device != the CPU's answer")
        if not (later.ok and np.array_equal(_ids_slots(later.result.network),
                                            later_want)):
            raise AssertionError(f"ids: the later query on {mesh or 'one'} "
                                 "device != the CPU's answer")
        say("ids", path="cooc_server", mesh=mesh or "none", terms=v,
            requests=len(reqs), bad_seeds=f"{v},{v + 3}",
            equal_to_cpu=True, later_query_ok=True)


def _ids_lm(dev):
    """llama3-8b at full width, IDS_LM_LAYERS layers, bf16 from a seeded
    generator: a prompt with a token past the padded vocab among good
    ones; its stream is all 0 (NaN logits argmax to 0, as the
    reference's), the good streams equal a run without it."""
    import torch
    from repro_torch.configs import replace
    from repro_torch.data import lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.serve import DecodeServer
    cfg = replace(lm_config("llama3-8b"), n_layers=IDS_LM_LAYERS)
    model = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, dtype=torch.bfloat16)
    toks = lm_batch(cfg, IDS_LM_PROMPTS, 24, step=0)["tokens"]
    lens = np.random.default_rng(0).integers(8, 25, IDS_LM_PROMPTS)
    prompts = [toks[i, :lens[i]].tolist() for i in range(IDS_LM_PROMPTS)]
    prompts[1][3] = cfg.padded_vocab + 7

    def streams(ps):
        srv = DecodeServer(cfg, model, slots=IDS_LM_SLOTS, max_len=64,
                           device=dev)
        rids = [srv.submit(p, max_new_tokens=IDS_LM_NEW) for p in ps]
        done = {r.rid: r.out_tokens for r in srv.run_until_drained()}
        torch.cuda.synchronize()
        return [done[r] for r in rids]

    with_bad = streams(prompts)
    without = streams(prompts[:1] + prompts[2:])
    if with_bad[1] != [0] * IDS_LM_NEW:
        raise AssertionError(f"ids: the bad prompt's stream {with_bad[1]}")
    if with_bad[:1] + with_bad[2:] != without:
        raise AssertionError("ids: a bad prompt moved another stream")
    later = streams(prompts[:1])
    if later != without[:1]:
        raise AssertionError("ids: a later decode differs")
    say("ids", path="decode_server", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, bad_token=cfg.padded_vocab + 7,
        good_streams_equal=True, later_decode_ok=True)
    _ids_embed_grad(dev, model.embed.detach())
    del model
    torch.cuda.empty_cache()


def _ids_embed_grad(dev, table):
    """The embedding's gradient through ``take`` at more tokens than rows
    (two of them out of range), as a training step at llama3-8b's
    ``train_4k`` feeds it: the same bits in two runs, as ``cfg.remat``'s
    gate in phase train compares gradients."""
    import torch
    from repro_torch.models.layers import take
    n = IDS_GRAD_TOKENS
    if n <= table.shape[0]:
        raise AssertionError(f"ids: {n} tokens do not outnumber "
                             f"{table.shape[0]} rows")
    gen = torch.Generator(device=dev).manual_seed(1)
    tok = torch.randint(0, table.shape[0], (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    tok[:2] = table.shape[0] + 7
    tok[1] = -table.shape[0] - 1
    up = torch.randn((n, table.shape[1]), generator=gen, device=dev,
                     dtype=table.dtype)
    grads = []
    for _ in range(2):
        with torch.enable_grad():
            t = table.clone().requires_grad_()
            (take(t, tok).nan_to_num(0.0) * up).sum().backward()
        grads.append(t.grad)
        del t
    torch.cuda.synchronize()
    if not torch.equal(grads[0], grads[1]):
        raise AssertionError("ids: the embedding's gradient differs between "
                             "two runs")
    say("ids", path="embed_grad", rows=table.shape[0], width=table.shape[1],
        tokens=n, dtype=str(table.dtype).replace("torch.", ""),
        same_bits=True)


def _ids_close(what, got, want):
    g, w = got.detach().cpu().numpy(), want.detach().numpy()
    if not np.array_equal(np.isnan(g), np.isnan(w)):
        raise AssertionError(f"ids: {what}: NaN at other positions than on "
                             "the CPU")
    if not np.isnan(w).any():
        raise AssertionError(f"ids: {what}: the bad id gave no NaN")
    ok = ~np.isnan(w)
    err = float(np.max(np.abs(g[ok] - w[ok]), initial=0.0))
    if not np.allclose(g[ok], w[ok], rtol=IDS_CPU_TOL, atol=IDS_CPU_TOL):
        raise AssertionError(f"ids: {what}: {err} from the CPU")
    return int(np.isnan(w).reshape(len(w), -1).any(axis=1).sum()), err


def _ids_models(dev):
    """dlrm-rm2 ``serve_fn`` at IDS_BATCH samples (through kernel 4),
    deepfm and sasrec, one bad id each in a few samples, and GIN over one
    bad edge source and one bad destination: NaN exactly where the CPU
    puts it, within IDS_CPU_TOL elsewhere; then a clean call."""
    import torch
    from repro_torch.configs import get_config, replace
    from repro_torch.data import gnn_synthetic_graph, recsys_batch
    from repro_torch.models import gnn as G
    from repro_torch.models import recsys as R
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    for arch in ("dlrm-rm2", "deepfm", "sasrec"):
        cfg = replace(get_config(arch), **SIDE_REDUCED,
                      seq_len=min(get_config(arch).seq_len, 16))
        host = R.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        card = type(host)(cfg, device=dev)
        card.load_state_dict(host.state_dict())
        b = recsys_batch(cfg, IDS_BATCH, 1)
        if arch == "sasrec":
            n = min(len(b["seq"]), 1024)
            b = {"seq": b["seq"][:n], "candidates": np.random.default_rng(
                0).integers(0, cfg.n_items, (n, IDS_CANDIDATES)).astype(
                    np.int32)}
            bad = {k: v.copy() for k, v in b.items()}
            bad["seq"][3, 2], bad["candidates"][5, 1] = 10 ** 6, -(10 ** 6)
        else:
            b = {k: b[k] for k in ("dense", "sparse_ids") if k in b}
            bad = {k: v.copy() for k, v in b.items()}
            bad["sparse_ids"][3, 2] = 10 ** 6
            bad["sparse_ids"][5, 0] = -(10 ** 9)
            bad["sparse_ids"][7, -1] = -1           # wraps into a row
        got = R.serve_fn(cfg, card, R.as_batch(bad, dev))
        torch.cuda.synchronize()
        n_nan, err = _ids_close(arch, got, R.serve_fn(cfg, host, R.as_batch(
            bad, "cpu")))
        clean = R.serve_fn(cfg, card, R.as_batch(b, dev))
        torch.cuda.synchronize()
        want = R.serve_fn(cfg, host, R.as_batch(b, "cpu"))
        if not torch.allclose(clean.cpu(), want, rtol=IDS_CPU_TOL,
                              atol=IDS_CPU_TOL):
            raise AssertionError(f"ids: {arch}: a later serve_fn differs")
        say("ids", path="serve_fn", arch=arch, batch=len(next(iter(
            b.values()))), nan_samples=n_nan, max_abs_err_vs_cpu=f"{err:.3g}",
            later_serve_ok=True)
        del host, card
    cfg = get_config("gin-tu")
    n, e = IDS_GIN
    g = gnn_synthetic_graph(n, e, 32, 8, seed=0)
    g["edge_src"][5], g["edge_dst"][9] = n, n + 3
    host = G.init_gin(cfg, torch.Generator().manual_seed(0), 32, 8,
                      device="cpu")
    card = G.GIN(cfg, 32, 8, device=dev)
    card.load_state_dict(host.state_dict())
    hb = {k: torch.from_numpy(v) for k, v in g.items()}
    args = ("x", "edge_src", "edge_dst")
    got = G.gin_forward(cfg, card, *(hb[k].to(dev) for k in args))
    torch.cuda.synchronize()
    n_nan, err = _ids_close("gin-tu", got, G.gin_forward(
        cfg, host, *(hb[k] for k in args)))
    say("ids", path="gin_forward", nodes=n, edges=e, nan_nodes=n_nan,
        max_abs_err_vs_cpu=f"{err:.3g}")


@serving
def phase_ids(dev):
    """Ids out of range on the card, each path then used again in the
    same process.  Returns the phase's kernel launches."""
    import torch
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    ops.reset_launches()
    _ids_cooc(dev)
    _ids_lm(dev)
    _ids_models(dev)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    for name in ("postings_counts", "level_step", "dot_interaction"):
        if launches[name] == 0:
            raise AssertionError(f"phase ids never launched {name}")
    say("ids", launches=json.dumps(launches),
        seconds=f"{time.perf_counter() - t0:.1f}")
    return launches


# the port's examples (examples/torch_*.py) at their smallest arguments,
# EXAMPLES_JOBS at a time, each in its own process on the card
EXAMPLES = (("torch_quickstart.py",), ("torch_full_network.py",),
            ("torch_streaming_window.py",), ("torch_snapshot_restore.py",),
            ("torch_sharded_query.py",), ("torch_serve_realtime.py",),
            ("torch_item_cooccur_recsys.py",),
            ("torch_cooccur_to_gnn.py", "--steps", "3"),
            ("torch_train_lm.py", "--steps", "3", "--batch", "2", "--seq",
             "32", "--ckpt-dir", "{tmp}/lm_ckpt"))
EXAMPLES_JOBS, EXAMPLES_TIMEOUT_S = 3, 300


def phase_examples(dev):
    """Each of EXAMPLES run in a subprocess on ``dev`` (``--device``); each
    must exit 0.  Prints each one's seconds and last line."""
    import os
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="examples-")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    todo = list(EXAMPLES)
    running = []
    failed = []
    try:
        while todo or running:
            while todo and len(running) < EXAMPLES_JOBS:
                script, *args = todo.pop(0)
                cmd = [sys.executable, str(ROOT / "examples" / script),
                       *(a.format(tmp=tmp) for a in args),
                       "--device", dev.type]
                log = open(os.path.join(tmp, script + ".log"), "w+")
                running.append((script, log, time.perf_counter(),
                                subprocess.Popen(cmd, env=env, stdout=log,
                                                 stderr=subprocess.STDOUT,
                                                 cwd=str(ROOT))))
            time.sleep(0.2)
            for item in list(running):
                script, log, t1, proc = item
                if proc.poll() is None:
                    if time.perf_counter() - t1 < EXAMPLES_TIMEOUT_S:
                        continue
                    proc.kill()
                    proc.wait()
                running.remove(item)
                log.seek(0)
                lines = log.read().splitlines()
                log.close()
                say("examples", script=script, rc=proc.returncode,
                    seconds=f"{time.perf_counter() - t1:.1f}",
                    last=repr(lines[-1] if lines else ""))
                if proc.returncode != 0:
                    failed.append(script)
                    print("\n".join(lines[-20:]), flush=True)
    finally:
        for _, log, _, proc in running:
            proc.kill()
            proc.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise AssertionError(f"examples failed: {failed}")
    say("examples", scripts=len(EXAMPLES), ok=True,
        seconds=f"{time.perf_counter() - t0:.1f}")


def main(argv=()) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dlrm-only", action="store_true",
                    help="build the kernels, serve dlrm-rm2 and time kernel "
                         "4, nothing else; prints no result line")
    ap.add_argument("--lm-only", action="store_true",
                    help="build the kernels and run the lm phase, nothing "
                         "else; prints no result line")
    ap.add_argument("--side-only", action="store_true",
                    help="build the kernels and run the side phase, "
                         "nothing else; prints no result line")
    ap.add_argument("--train-only", action="store_true",
                    help="build the kernels and run the train phase, "
                         "nothing else; prints no result line")
    ap.add_argument("--launch-only", action="store_true",
                    help="build the kernels and run the launch phase, "
                         "nothing else; prints no result line")
    ap.add_argument("--ids-only", action="store_true",
                    help="build the kernels and run the ids and examples "
                         "phases, nothing else; prints no result line")
    args = ap.parse_args(argv)
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
    if args.dlrm_only:
        launches = {}
        kernels = [phase_kernel_dot(dev, *phase_dlrm(dev, launches),
                                    launches)]
        say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
        print(card, flush=True)
        print(json.dumps({"kernels": kernels}), flush=True)
        return 0
    if args.train_only or args.launch_only:
        (phase_train if args.train_only else phase_launch)(dev)
        say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
        print(card, flush=True)
        return 0
    if args.lm_only or args.side_only:
        (phase_lm if args.lm_only else phase_side)(dev)
        say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
        print(card, flush=True)
        return 0
    if args.ids_only:
        phase_ids(dev)
        phase_examples(dev)
        say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
        print(card, flush=True)
        return 0
    phase_strings(dev)
    ctx, hidx, seeds, launches = phase_csl(dev)
    exact, exact_s = phase_materialize(dev, ctx, hidx, launches)
    approx = phase_approx(dev, ctx, hidx, exact, exact_s)
    kernels = phase_kernels(dev, ctx, seeds, launches)
    phase_mesh(dev, ctx, seeds, exact, exact_s, *approx)
    del ctx, hidx, exact, approx       # the CSL artifacts, about 33 GB
    torch.cuda.empty_cache()
    phase_serve(dev, phase_snapshot(dev, phase_stream(dev)[1]))
    dlrm = phase_dlrm(dev, launches)
    kernels.append(phase_kernel_dot(dev, *dlrm, launches))
    del dlrm                           # the 6.7 GB table and the batches
    torch.cuda.empty_cache()
    phase_decode(dev, launches)
    kernels.append(phase_kernel_decode(dev, launches))
    phase_lm(dev)
    phase_side(dev)
    train = phase_train(dev)
    dot = next(k for k in kernels if k["name"] == "dot_interaction")
    dot.update(train_launches=train["launches"],
                       backward_ms=train["backward"]["ms"],
                       backward_bound_ms=train["backward"]["bound_ms"])
    launch = phase_launch(dev)
    ids = phase_ids(dev)
    for k in kernels:
        k["launch_launches"] = launch[k["name"]]
        k["ids_launches"] = ids[k["name"]]
    phase_examples(dev)
    say("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
