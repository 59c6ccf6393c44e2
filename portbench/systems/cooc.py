"""Running the co-occurrence engine (``repro_torch``): set-up, the three
loops a traffic file can name, and the comparison that decides ``correct``.

The program receives only the generated documents and queries, through
its public entry points: ``QueryContext`` and its ``ingest``,
``CoocServer.submit`` / ``.ingest``, ``CoocEngine.submit`` / ``.step``,
and ``materialize``.  Everything the checks compare against comes from
:mod:`portbench.reference`, which builds its own index from the same
documents once the window has closed and the program's state is freed.

Loops (a traffic file's ``"loop"``):

* ``"open"``: Poisson-like open-loop requests to a ``CoocServer`` at a
  fixed rate (``rate_per_s``), one seed each, head and tail seeds in
  turns; optionally a block of new documents ingested every ``every_s``
  seconds.  A request's latency runs from the time it was due.
* ``"network"``: one analyst in a closed loop, the whole network again
  and again.
* ``"batch"``: a closed loop of ``queries`` outstanding queries served as
  one engine batch, seeds drawn as the corpus draws its tokens.
"""
from __future__ import annotations

import asyncio
import gc
import io
import math
import os
import shutil
import tempfile
import time
from collections import Counter
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from portbench import corpus, reference
from portbench.outcome import Check, Outcome
from portbench.trace import Recorder

TENANT = "bench"
#: seconds past the window's close that a request may still take
DRAIN_S = 60.0
#: requests served one at a time to warm a plan: more than the server's
#: step-time model keeps (``ServerConfig.model_window``, 32)
WARM_SINGLES = 40
#: full batches served after them
WARM_BATCHES = 4


def run(cfg: Mapping, traffic: Mapping, cell: Mapping, *, seed: int,
        seconds: float, trace: bool, device, t_start: float) -> Outcome:
    loop = traffic["loop"]
    if loop == "open":
        return asyncio.run(_open(cfg, traffic, cell, seed, seconds, trace,
                                 device, t_start))
    if loop == "network":
        return _network(cfg, traffic, cell, seed, seconds, trace, device,
                        t_start)
    if loop == "batch":
        return _batch(cfg, traffic, cell, seed, seconds, trace, device,
                      t_start)
    raise ValueError(f"unknown loop {loop!r} (open, network, batch)")


# -- inputs ---------------------------------------------------------------


def corpus_docs(cfg: Mapping, seed: int, device) -> torch.Tensor:
    """The configuration's documents (the initial window, for a window
    configuration), drawn on ``device`` from ``seed``."""
    return corpus.draw_docs(int(cfg["n_docs"]), int(cfg["vocab_size"]),
                            cfg["corpus"], corpus.generator(seed, "docs",
                                                            device))


def stream_docs(cfg: Mapping, traffic: Mapping, seed: int, seconds: float,
                device) -> Optional[torch.Tensor]:
    """The blocks a window's ingests bring: the warm-up block, then one
    per ``every_s`` of the window."""
    spec = traffic.get("ingest")
    if not spec:
        return None
    n = 1 + n_ingests(spec, seconds)
    return corpus.draw_docs(n * int(spec["docs"]), int(cfg["vocab_size"]),
                            cfg["corpus"], corpus.generator(seed, "stream",
                                                            device))


def n_ingests(spec: Mapping, seconds: float) -> int:
    """Ingests in a window: one at (j + 0.5) * every_s for each j that
    falls inside it."""
    return max(1, int(math.floor(seconds / float(spec["every_s"]) + 0.5)))


def open_requests(traffic: Mapping, df: np.ndarray, seed: int,
                  seconds: float):
    """(due seconds, seeds) of an open-loop window: a fixed count of
    arrivals, ``rate_per_s * seconds``, spread uniformly at random over the
    window (a Poisson process given its count), so every seed offers the
    same number of requests."""
    n = int(round(float(traffic["rate_per_s"]) * seconds))
    due = np.sort(corpus.rng(seed, "arrivals").uniform(0.0, seconds, n))
    seeds = corpus.head_tail_seeds(df, n, int(traffic["head_terms"]),
                                   traffic["tail_df"],
                                   corpus.rng(seed, "seeds"))
    return due, seeds


def sample(n: int, k: int, seed: int, what: str) -> np.ndarray:
    """``k`` of ``n`` indices drawn from ``seed``, sorted."""
    k = min(k, n)
    return np.sort(corpus.rng(seed, what).choice(n, k, replace=False))


def _lists(block: torch.Tensor) -> List[List[int]]:
    """A (n, M) -1-padded block as the lists of term ids users send."""
    return [[t for t in row if t >= 0] for row in block.cpu().tolist()]


# -- the program ----------------------------------------------------------


def _committed(cold_dir: str) -> List[str]:
    """The cold store's committed block files, in spill order."""
    return sorted(f for f in os.listdir(cold_dir)
                  if f.startswith("block-") and f.endswith(".bin"))


def _stored_blocks(cold_dir: str) -> List[bytes]:
    """The spilled blocks' payloads in spill order, read from the files."""
    out = []
    for f in _committed(cold_dir):
        with open(os.path.join(cold_dir, f), "rb") as fh:
            out.append(fh.read())
    return out


def _uncommitted(cfg: Mapping, n_fill: int, cold_dir: str,
                 n_ingests: int) -> int:
    """Blocks that should be committed to the cold store once the
    ``n_ingests``-th ingest after the fill has returned and are not, plus
    blocks committed too many and temporary files left behind."""
    win = cfg["window"]
    want = len(evicted_blocks(n_fill, int(win["block"]), int(win["docs"]),
                              n_ingests))
    names = os.listdir(cold_dir)
    temps = sum(1 for f in names if ".tmp-" in f)
    return abs(want - len(_committed(cold_dir))) + temps


def _context(cfg: Mapping, docs: torch.Tensor, device, store=None):
    """The program's index of ``docs``: all of them at once for a static
    configuration, or block by block into a window with a cold store."""
    from repro_torch.core import PackedIndex, QueryContext
    v = int(cfg["vocab_size"])
    win = cfg.get("window")
    n = docs.shape[0]
    cap = int(win["docs"]) if win else n
    empty = PackedIndex(
        torch.zeros(((cap + 31) // 32, v), dtype=torch.int32, device=device),
        torch.zeros((v,), dtype=torch.int32, device=device), 0)
    if not win:
        ctx = QueryContext(empty, device=device)
        ctx.ingest(docs, torch.ones(n, dtype=torch.bool))
        return ctx
    ctx = QueryContext(empty, device=device, window=cap,
                       cold_store=store)
    b = int(win["block"])
    for lo in range(0, n, b):
        part = docs[lo:lo + b]
        ctx.ingest(part, torch.ones(part.shape[0], dtype=torch.bool))
    return ctx


def _server_config(s: Mapping):
    from repro_torch.serve import AdmissionPolicy, ServerConfig
    return ServerConfig(
        depth=int(s["depth"]), topk=int(s["topk"]), beam=int(s["beam"]),
        q_batch=int(s["q_batch"]), method=s["method"],
        compile_budget=int(s["compile_budget"]),
        policy=AdmissionPolicy(max_queue_depth=int(s["max_queue_depth"]),
                               max_wait_ms=float(s["max_wait_ms"])),
        default_deadline_ms=float(s["default_deadline_ms"]),
        linger_ms=float(s["linger_ms"]))


def _request(plan: Mapping, method: str, seed: int) -> dict:
    return {"seeds": [int(seed)], "depth": int(plan["depth"]),
            "topk": int(plan["topk"]), "beam": int(plan["beam"]),
            "method": method}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _launches() -> Dict[str, int]:
    from repro_torch.kernels import ops
    return dict(ops.LAUNCHES)


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in _launches().items()}


class _StepSpans:
    """While installed, every ``CoocEngine.step`` runs inside a harness
    span, and the seeds it served (the public ``finished`` record's newest
    entries) are kept in ``batches``."""

    def __init__(self, rec: Recorder):
        from repro_torch.serve.cooc_engine import CoocEngine
        self.cls, self.rec, self.batches = CoocEngine, rec, []
        self.orig = CoocEngine.step

    def __enter__(self):
        orig, rec, batches = self.orig, self.rec, self.batches

        def step(engine):
            with rec.span("step"):
                n = orig(engine)
            if n:
                batches.append([list(r.spec.seeds)
                                for r in list(engine.finished)[-n:]])
            return n

        self.cls.step = step
        return self

    def __exit__(self, *exc):
        self.cls.step = self.orig
        return False


def _edges(net) -> List[tuple]:
    """A served network's edges in slot order: (src, dst, weight) of each
    valid slot."""
    ok = np.asarray(net.valid).astype(bool)
    return list(zip(np.asarray(net.src)[ok].tolist(),
                    np.asarray(net.dst)[ok].tolist(),
                    np.asarray(net.weight)[ok].tolist()))


def _word_of(doc: torch.Tensor) -> torch.Tensor:
    """A static index's packed word row of each document: 32 documents a
    word, in ingest order."""
    return doc // 32


def _bfs_stats(index, batches: Sequence[Sequence[int]], plan: Mapping,
               chunk: int = 256) -> List[dict]:
    """The reference's per-(batch, level) frontier statistics of the
    served batches (each a list of queries' seed lists), a chunk of whole
    batches at a time."""
    stats: List[dict] = []
    per = max(1, chunk // max(1, max(len(b) for b in batches)))
    for b0 in range(0, len(batches), per):
        part = batches[b0:b0 + per]
        seeds = [s for b in part for s in b]
        groups = [b0 + i for i, b in enumerate(part) for _ in b]
        reference.bfs(index, seeds, depth=int(plan["depth"]),
                      topk=int(plan["topk"]), beam=int(plan["beam"]),
                      stats=stats, groups=groups,
                      word_of=_word_of)
    return stats


def _p95(values: np.ndarray) -> float:
    """Nearest-rank 95th percentile."""
    v = np.sort(values)
    return float(v[max(0, int(math.ceil(0.95 * len(v))) - 1)])


# -- loop: open -----------------------------------------------------------


async def _open(cfg, traffic, cell, seed, seconds, trace, device, t_start):
    from repro_torch.serve import CoocServer, TenantConfig
    s_cfg, plan = cfg["server"], traffic["plan"]
    v = int(cfg["vocab_size"])
    win = cfg.get("window")
    docs = corpus_docs(cfg, seed, device)
    stream = stream_docs(cfg, traffic, seed, seconds, device)
    df = corpus.doc_freq(docs, v)
    due, seeds = open_requests(traffic, df, seed, seconds)
    q = int(s_cfg["q_batch"])
    warm = corpus.head_tail_seeds(df, WARM_SINGLES + q * WARM_BATCHES,
                                  int(traffic["head_terms"]),
                                  traffic["tail_df"], corpus.rng(seed, "warm"))
    spec = traffic.get("ingest")
    blocks = []
    if spec:
        b = int(spec["docs"])
        blocks = [_lists(stream[i * b:(i + 1) * b])
                  for i in range(stream.shape[0] // b)]
    cold_dir = tempfile.mkdtemp(prefix="portbench-cold-") if win else None
    try:
        from repro_torch.core import FileStorage
        ctx = _context(cfg, docs, device,
                       FileStorage(cold_dir) if win else None)
        server = CoocServer(ctx, [TenantConfig(TENANT)],
                            _server_config(s_cfg))
        await server.start()
        method = s_cfg["method"]
        # one request at a time first: the first step builds the kernels,
        # and the steps after it push that build out of the server's
        # step-time model, which would otherwise shed the window's traffic
        for s in warm[:WARM_SINGLES]:
            await server.submit(TENANT, _request(plan, method, s),
                                deadline_ms=DRAIN_S * 1e3)
        for i in range(WARM_BATCHES):
            await asyncio.gather(*[
                server.submit(TENANT, _request(plan, method, s),
                              deadline_ms=DRAIN_S * 1e3)
                for s in warm[WARM_SINGLES + i * q:
                              WARM_SINGLES + (i + 1) * q]])
        # each evicting ingest's block committed before the ingest returns
        uncommitted = 0
        if blocks:
            await server.ingest(TENANT, blocks[0])
            uncommitted += _uncommitted(cfg, docs.shape[0], cold_dir, 1)
        _sync(device)
        setup_s = time.monotonic() - t_start
        epoch0 = ctx.epoch
        n = len(due)
        lat = np.full(n, np.nan)
        status: List[Optional[str]] = [None] * n
        occupancy = np.zeros(n, np.int64)
        # only the answers the check will read are kept: a window's worth
        # of results would grow the heap that the collector walks
        keep = set(sample(n, int(cell["check"]["sample"]), seed,
                          "check").tolist())
        results: Dict[int, object] = {}
        late = np.zeros(n)
        ingest_ms: List[float] = []
        before = _launches()
        with Recorder(trace) as rec:
            steps = _StepSpans(rec) if trace else None
            if steps:
                steps.__enter__()
            try:
                with rec.window():
                    t0 = time.monotonic()

                    async def one(i):
                        late[i] = time.monotonic() - (t0 + due[i])
                        r = await server.submit(
                            TENANT, _request(plan, method, seeds[i]))
                        lat[i] = (time.monotonic() - (t0 + due[i])) * 1e3
                        status[i] = r.status
                        if r.result is not None:
                            occupancy[i] = r.result.batch_occupancy
                            if i in keep:
                                results[i] = r.result

                    pending = set()

                    async def dispatch():
                        for i in range(n):
                            wait = t0 + due[i] - time.monotonic()
                            if wait > 0:
                                await asyncio.sleep(wait)
                            task = asyncio.create_task(one(i))
                            pending.add(task)
                            task.add_done_callback(pending.discard)

                    async def ingest():
                        nonlocal uncommitted
                        for j in range(1, len(blocks)):
                            wait = t0 + (j - 0.5) * float(spec["every_s"]) \
                                - time.monotonic()
                            if wait > 0:
                                await asyncio.sleep(wait)
                            t = time.monotonic()
                            with rec.span("ingest"):
                                await server.ingest(TENANT, blocks[j])
                            ingest_ms.append((time.monotonic() - t) * 1e3)
                            uncommitted += _uncommitted(
                                cfg, docs.shape[0], cold_dir, 1 + j)

                    ing = asyncio.create_task(ingest())
                    await dispatch()
                    close = t0 + seconds
                    if close > time.monotonic():
                        await asyncio.sleep(close - time.monotonic())
                    done, late_tasks = await asyncio.wait(
                        list(pending) + [ing], timeout=DRAIN_S)
                    for t in late_tasks:
                        t.cancel()
                    for t in done:
                        t.result()
                    _sync(device)
            finally:
                if steps:
                    steps.__exit__(None, None, None)
        launches = _delta(before)
        peak = _peak_bytes(device)
        epoch_end = ctx.epoch
        await server.stop(drain=False)
        del server, ctx
        _free(device)

        failed_ms = (seconds + DRAIN_S) * 1e3
        ok = np.array([st == "ok" for st in status])
        counted = np.where(ok, lat, failed_ms)
        obs = {"statuses": status,
               "occupancy": occupancy[occupancy > 0].tolist(),
               "launches": launches, "trace": rec.trace,
               "batches": steps.batches if steps else None}

        # -- the checks, on the reference's own index ----------------------
        all_docs = docs if stream is None else torch.cat(
            [docs, stream[:len(blocks) * int(spec["docs"])]])
        index = reference.Index(all_docs, v)
        checks = _check_open(index, cfg, traffic, seeds, results, status,
                             docs.shape[0], epoch0, len(ingest_ms),
                             epoch_end)
        if win:
            checks += _check_cold(_stored_blocks(cold_dir), cfg, docs,
                                  stream, 1 + len(ingest_ms))
            checks.append(Check("blocks_uncommitted_at_return", uncommitted,
                                0))
        if trace and not win and steps.batches:
            obs["bfs_stats"] = _bfs_stats(index, steps.batches, plan)
            obs["shape"] = {"n_docs": int(cfg["n_docs"]), "vocab": v,
                            "n_words": (int(cfg["n_docs"]) + 31) // 32,
                            "k": int(plan["topk"])}
        del index
        _free(device)
    finally:
        if cold_dir:
            shutil.rmtree(cold_dir, ignore_errors=True)
    e2e = {"query_p95_ms": _p95(counted), "device_peak_gb": peak / 1e9,
           "setup_s": setup_s}
    if ingest_ms:
        e2e["ingest_ms"] = sum(ingest_ms) / len(ingest_ms)
    return Outcome(
        e2e=e2e,
        obs=obs, attempted=n, failed=int((~ok).sum()), checks=checks,
        peak_bytes=peak, trace=rec.trace,
        notes={"generator_late_p95_ms": _p95(late * 1e3) if n else 0.0,
               "statuses": dict(Counter(map(str, status))),
               "ingest_ms_max": max(ingest_ms, default=0.0)})


def evicted_blocks(n_fill: int, block: int, window: int,
                   n_blocks_after: int) -> List[tuple]:
    """[start, end) of each block evicted once ``n_blocks_after`` blocks
    followed the fill (see :func:`live_range`), oldest first."""
    lo, _ = live_range(n_fill, block, window, n_blocks_after)
    starts = list(range(0, n_fill, block)) + [n_fill + j * block
                                              for j in range(n_blocks_after)]
    return [(s, min(s + block, n_fill) if s < n_fill else s + block)
            for s in starts if s < lo]


def live_range(n_fill: int, block: int, window: int, n_blocks_after: int):
    """[lo, hi) of the live documents after ``n_blocks_after`` blocks of
    ``block`` documents followed the fill of ``n_fill`` (itself ingested
    in blocks of ``block``): the newest whole blocks whose documents fit
    in ``window``."""
    sizes = [min(block, n_fill - lo) for lo in range(0, n_fill, block)]
    sizes += [block] * n_blocks_after
    hi = sum(sizes)
    lo, live = hi, 0
    for s in reversed(sizes):
        if live + s > window:
            break
        live += s
        lo -= s
    return lo, hi


def _check_open(index, cfg, traffic, seeds, results, status, n_fill,
                epoch0, n_window_ingests, epoch_end):
    """The answers of a sample of the offered requests (``results``: those
    of the sample that were served) against the reference, each at its own
    epoch's live documents."""
    plan = traffic["plan"]
    pick = sorted(results)
    win = cfg.get("window")
    lo, hi, bad_epoch = [], [], []
    for i in pick:
        if win:
            k = results[i].epoch - epoch0        # window ingests before it
            bad_epoch.append(not 0 <= k <= n_window_ingests)
            a, b = live_range(n_fill, int(win["block"]), int(win["docs"]),
                              1 + max(0, min(k, n_window_ingests)))
        else:
            bad_epoch.append(results[i].epoch != epoch0)
            a, b = 0, n_fill
        lo.append(a)
        hi.append(b)
    want = reference.bfs(index, [int(seeds[i]) for i in pick],
                         depth=int(plan["depth"]), topk=int(plan["topk"]),
                         beam=int(plan["beam"]), lo=lo, hi=hi)
    wrong = sum(1 for i, w, e in zip(pick, want, bad_epoch)
                if e or _edges(results[i].network) != w)
    lost = sum(1 for st in status if st in (None, "error"))
    checks = [Check("answers_wrong", wrong, 0),
              Check("answers_lost", lost, 0),
              Check("answers_checked", len(pick), 1, at_least=True)]
    if win:
        checks.append(Check("epochs_off", abs(epoch_end - epoch0
                                              - n_window_ingests), 0))
    return checks


def _check_cold(blocks: List[bytes], cfg, docs, stream, n_blocks_after):
    """Every block evicted from the window, read back from the cold store
    and held to the reference's bitmap of its documents."""
    win = cfg["window"]
    b, v = int(win["block"]), int(cfg["vocab_size"])
    all_docs = torch.cat([docs, stream[:n_blocks_after * b]])
    evicted = evicted_blocks(docs.shape[0], b, int(win["docs"]),
                             n_blocks_after)
    wrong = 0
    for (s, e), raw in zip(evicted, blocks):
        with np.load(io.BytesIO(raw), allow_pickle=False) as z:
            got = (np.asarray(z["packed"], np.uint32),
                   np.asarray(z["doc_freq"]), int(z["n_docs"]),
                   int(z["vocab"]))
        packed, df = reference.cold_block(all_docs[s:e], v)
        if not (got[0].shape == packed.shape and (got[0] == packed).all()
                and (got[1] == df).all() and got[2] == e - s
                and got[3] == v):
            wrong += 1
    return [Check("cold_blocks_wrong", wrong, 0),
            Check("cold_blocks_missing", abs(len(evicted) - len(blocks)), 0),
            Check("cold_blocks_checked", min(len(evicted), len(blocks)), 1,
                  at_least=True)]


# -- loop: network --------------------------------------------------------


def network_terms(df: np.ndarray, n: int, seed: int) -> np.ndarray:
    """The network rows a run checks: the 16 most frequent terms and the
    rest drawn from the terms with postings."""
    head = np.argsort(-df, kind="stable")[:min(16, n)]
    rest = np.setdiff1d(np.flatnonzero(df > 0), head)
    pick = corpus.rng(seed, "check").choice(rest, min(n - len(head),
                                                      len(rest)),
                                            replace=False)
    return np.sort(np.concatenate([head, pick])).astype(np.int64)


def _network(cfg, traffic, cell, seed, seconds, trace, device, t_start):
    from repro_torch.core import materialize
    v = int(cfg["vocab_size"])
    k, method = int(traffic["k"]), traffic["method"]
    docs = corpus_docs(cfg, seed, device)
    # the rows the check reads, and their flat slots (term * k + rank):
    # of each network only these outlive the iteration that built it, so
    # the device's peak holds no network the harness kept
    terms = network_terms(corpus.doc_freq(docs, v),
                          int(cell["check"]["sample"]), seed)
    sl = (torch.as_tensor(terms, device=device)[:, None] * k
          + torch.arange(k, device=device)).reshape(-1)
    ctx = _context(cfg, docs, device)
    # use_cache=False: the context would hand back its cached network
    materialize(ctx, k=k, method=method, use_cache=False)
    _sync(device)
    setup_s = time.monotonic() - t_start
    got = []
    before = _launches()
    with Recorder(trace) as rec:
        with rec.window():
            t0 = time.monotonic()
            while time.monotonic() - t0 < seconds:
                with rec.span("materialize"):
                    net = materialize(ctx, k=k, method=method,
                                      use_cache=False)
                    _sync(device)
                got.append(tuple(x[sl].cpu().numpy().reshape(-1, k)
                                 for x in (net.dst, net.weight, net.src)))
                del net
            t_last = time.monotonic()
    launches = _delta(before)
    peak = _peak_bytes(device)
    del ctx
    _free(device)
    index = reference.Index(docs, v)
    dst, wt = reference.network_rows(index, terms, k)
    wrong = 0
    for g_dst, g_wt, g_src in got:
        bad = ((g_dst != dst) | (g_wt != wt)).any(1) | \
            (g_src != terms[:, None]).any(1)
        wrong += int(bad.sum())
    n_nets = len(got)
    obs = {"networks": n_nets, "launches": launches, "trace": rec.trace}
    if trace:
        obs["network_work"] = reference.network_work(
            index, _word_of)
        obs["shape"] = {"n_docs": int(cfg["n_docs"]), "vocab": v,
                        "n_words": (int(cfg["n_docs"]) + 31) // 32, "k": k}
    del index
    _free(device)
    return Outcome(
        e2e={"network_s": (t_last - t0) / n_nets,
             "device_peak_gb": peak / 1e9, "setup_s": setup_s},
        obs=obs, attempted=n_nets, failed=0,
        checks=[Check("rows_wrong", wrong, 0),
                Check("rows_checked", len(terms) * n_nets, 1,
                      at_least=True)],
        peak_bytes=peak, trace=rec.trace, notes={})


# -- loop: batch ----------------------------------------------------------


def batch_seeds(cfg: Mapping, traffic: Mapping, gen: torch.Generator,
                n_batches: int) -> np.ndarray:
    """(n_batches, queries, seeds_per_query) seeds drawn as the corpus
    draws its tokens."""
    q, s = int(traffic["queries"]), int(traffic["seeds_per_query"])
    return corpus.zipf_seeds(n_batches * q * s, int(cfg["vocab_size"]),
                             cfg["corpus"], gen).reshape(n_batches, q, s)


def _query(row) -> List[int]:
    return [int(s) for s in row]


#: batches drawn in set-up, per second of the window (far more than a
#: full-size batch of about a second needs; a window that needs more draws
#: more)
BATCHES_PER_S = 200


def _batch(cfg, traffic, cell, seed, seconds, trace, device, t_start):
    from repro_torch.serve import CoocEngine
    v = int(cfg["vocab_size"])
    plan = traffic["plan"]
    docs = corpus_docs(cfg, seed, device)
    max_batches = int(seconds * BATCHES_PER_S) + 2
    gen = corpus.generator(seed, "seeds", device)
    seeds = batch_seeds(cfg, traffic, gen, max_batches)
    warm = batch_seeds(cfg, traffic, corpus.generator(seed, "warm", device),
                       1)[0]
    ctx = _context(cfg, docs, device)
    q = int(traffic["queries"])
    eng = CoocEngine(ctx, device=device, depth=int(plan["depth"]),
                     topk=int(plan["topk"]), beam=int(plan["beam"]),
                     q_batch=q, method=traffic["method"])
    futs = [eng.submit(_query(s)) for s in warm]
    eng.step()
    if not all(f.done() for f in futs):
        raise RuntimeError("the warm-up batch left queries queued")
    _sync(device)
    setup_s = time.monotonic() - t_start
    results = []
    before = _launches()
    with Recorder(trace) as rec:
        with rec.window():
            t0 = time.monotonic()
            b = 0
            while time.monotonic() - t0 < seconds:
                if b == len(seeds):
                    seeds = np.concatenate(
                        [seeds, batch_seeds(cfg, traffic, gen, max_batches)])
                futs = [eng.submit(_query(s)) for s in seeds[b]]
                with rec.span("step"):
                    eng.step()
                results.append([f.result() for f in futs])
                b += 1
            t_last = time.monotonic()
    launches = _delta(before)
    peak = _peak_bytes(device)
    eng.shutdown(drain=False)
    del eng, ctx
    _free(device)
    n_done = sum(len(r) for r in results)
    flat = [(b, i) for b in range(len(results)) for i in range(q)]
    pick = [flat[i] for i in sample(len(flat), int(cell["check"]["sample"]),
                                    seed, "check")]
    index = reference.Index(docs, v)
    want = reference.bfs(index, [_query(seeds[b][i]) for b, i in pick],
                         depth=int(plan["depth"]), topk=int(plan["topk"]),
                         beam=int(plan["beam"]))
    wrong = sum(1 for (b, i), w in zip(pick, want)
                if _edges(results[b][i].network) != w)
    obs = {"launches": launches, "trace": rec.trace}
    if trace:
        obs["bfs_stats"] = _bfs_stats(
            index, [[_query(s) for s in seeds[b]]
                    for b in range(len(results))], plan)
        obs["shape"] = {"n_docs": int(cfg["n_docs"]), "vocab": v,
                        "n_words": (int(cfg["n_docs"]) + 31) // 32,
                        "k": int(plan["topk"])}
    del index
    _free(device)
    return Outcome(
        e2e={"queries_per_s": n_done / (t_last - t0),
             "device_peak_gb": peak / 1e9, "setup_s": setup_s},
        obs=obs, attempted=n_done, failed=0,
        checks=[Check("answers_wrong", wrong, 0),
                Check("answers_checked", len(pick), 1, at_least=True)],
        peak_bytes=peak, trace=rec.trace, notes={})
