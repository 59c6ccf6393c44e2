"""CoocEngine — plan-aware, micro-batched co-occurrence query serving.

Mirrors ``repro.serve.cooc_engine``: queries are typed QuerySpecs;
:meth:`CoocEngine.submit` returns a :class:`CoocFuture`; each
:meth:`CoocEngine.step` admits up to ``q_batch`` queued requests of the
head-of-queue plan into a fixed ``(q_batch, beam)`` seed batch (idle slots
padded with -1 seeds, which produce no edges) and runs the plan's executor
once.  The executor of a plan is a plain callable, cached per
:func:`canonical_exec_key` in an LRU bounded by ``compile_budget``; every
batch gets a scope bitmap (the context's all-ones ``full_mask`` for an
unscoped plan), so scoped and unscoped plans share one executor.  A step
synchronises with the device once, when it copies the batch's network to
the host.  While a profile records, :mod:`repro_torch.tracing` spans
``cooc.engine.submit``, and the step's host work before its levels
(``cooc.engine.prepare``) and after that copy (``cooc.engine.resolve``).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from collections import OrderedDict, deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.cooccurrence import bfs_construct_batch
from repro_torch.core.inverted_index import PackedIndex
from repro_torch.core.network import CoocNetwork
from repro_torch.core.query import (
    PlanKey,
    QueryResult,
    QuerySpec,
    canonical_exec_key,
    get_count_method,
)
from repro_torch.core.query_context import QueryContext
from repro_torch.device import canonical_device, resolve_device
from repro_torch.serve.metrics import percentile_ms


class EngineClosedError(RuntimeError):
    """Raised by :meth:`CoocEngine.submit` after :meth:`CoocEngine.shutdown`,
    and set as the error on any request flushed by a non-draining shutdown."""


@dataclasses.dataclass
class CoocRequest:
    """Engine-internal record of one submitted query."""
    rid: int
    spec: QuerySpec
    t_submit: float = 0.0
    t_done: float = 0.0
    result: Optional[QueryResult] = None
    error: Optional[Exception] = None

    @property
    def seed_terms(self) -> List[int]:
        return list(self.spec.seeds)

    @property
    def edges(self) -> Optional[Dict[Tuple[int, int], int]]:
        return self.result.edges() if self.result is not None else None

    @property
    def latency_ms(self) -> float:
        return (self.t_done - self.t_submit) * 1e3

    @property
    def batch_occupancy(self) -> int:
        return self.result.batch_occupancy if self.result is not None else 0


class CoocFuture:
    """Handle for a submitted query: ``done()`` does not block;
    ``result()`` drives the engine until this request is served and
    returns its QueryResult, or raises the error it failed with."""

    __slots__ = ("_engine", "_req")

    def __init__(self, engine: "CoocEngine", req: CoocRequest):
        self._engine = engine
        self._req = req

    @property
    def rid(self) -> int:
        return self._req.rid

    @property
    def spec(self) -> QuerySpec:
        return self._req.spec

    def done(self) -> bool:
        return self._req.result is not None or self._req.error is not None

    def result(self) -> QueryResult:
        while self._req.result is None and self._req.error is None:
            if self._engine.step() == 0:
                raise RuntimeError(
                    f"request {self._req.rid} is not queued in its engine "
                    "(queue drained without serving it)")
        if self._req.error is not None:
            raise self._req.error
        return self._req.result


@dataclasses.dataclass
class EngineStats:
    n: int
    p50_ms: float
    p95_ms: float
    p99_ms: float
    max_ms: float
    batches: int = 0
    mean_occupancy: float = 0.0   # mean admitted queries per executed batch
    compiled_plans: int = 0       # distinct executors currently cached
    failed_total: int = 0         # requests resolved onto an error
    p999_ms: float = 0.0
    window: int = 0               # ring-buffer capacity the quantiles cover
    plan_evictions: int = 0       # executors dropped by the budget


class CoocEngine:
    """Plan-aware micro-batched BFS query engine over a QueryContext.

    ``depth/topk/beam/dedup/method`` are the default spec for bare seed
    lists; any mix of QuerySpecs is served, grouped by plan.  ``window``
    bounds the stats ring buffers; ``compile_budget`` bounds the executor
    cache (LRU; None = unbounded).  ``device`` must be the context's
    device; it defaults to ``cuda`` like every entry point of the port."""

    def __init__(self, ctx, *, device="cuda", depth: int = 3,
                 topk: int = 16, beam: int = 32, q_batch: int = 8,
                 method: str = "gemm", dedup: bool = True,
                 on_overflow: str = "raise", window: int = 2048,
                 compile_budget: Optional[int] = None):
        dev = resolve_device(device)
        get_count_method(method)
        if compile_budget is not None and compile_budget < 1:
            raise ValueError(
                f"compile_budget must be >= 1 or None, got {compile_budget}")
        if isinstance(ctx, PackedIndex):
            ctx = QueryContext(ctx, device=dev)
        if canonical_device(ctx.device) != canonical_device(dev):
            raise ValueError(f"context lives on {ctx.device}, engine asked "
                             f"for {dev}")
        self.ctx: QueryContext = ctx
        self.depth, self.topk, self.beam = depth, topk, beam
        self.dedup, self.method = dedup, method
        self.q_batch = q_batch
        self.on_overflow = on_overflow
        self.window = window
        self.compile_budget = compile_budget
        self.queue: List[CoocRequest] = []
        self.finished: Deque[CoocRequest] = deque(maxlen=window)
        self.latencies_ms: Deque[float] = deque(maxlen=window)
        self.batch_occupancy: Deque[int] = deque(maxlen=window)
        self.served_total = 0
        self.batches_total = 0
        self.failed_total = 0
        self.plan_evictions_total = 0
        self._next_rid = 0
        self._closed = False
        self._executors: "OrderedDict[PlanKey, Callable]" = OrderedDict()
        #: optional hook fired with each LRU-evicted exec key
        self.on_plan_evict: Optional[Callable[[PlanKey], None]] = None

    # -- plan cache ---------------------------------------------------------

    @property
    def compiled_plans(self) -> int:
        """Size of the executor cache: grows with distinct executor
        identities, never with query count or past ``compile_budget``."""
        return len(self._executors)

    @property
    def closed(self) -> bool:
        return self._closed

    def _executor(self, key: PlanKey):
        """Executor of ``key`` from the LRU cache, keyed on
        :func:`canonical_exec_key` (the scope name erased)."""
        exec_key = canonical_exec_key(key)
        fn = self._executors.get(exec_key)
        if fn is not None:
            self._executors.move_to_end(exec_key)
            return fn
        fn = functools.partial(bfs_construct_batch, depth=key.depth,
                               topk=key.topk, beam=key.beam, dedup=key.dedup,
                               method=key.method, mesh=self.ctx.mesh)
        self._executors[exec_key] = fn
        if self.compile_budget is not None:
            while len(self._executors) > self.compile_budget:
                evicted, _ = self._executors.popitem(last=False)
                self.plan_evictions_total += 1
                if self.on_plan_evict is not None:
                    self.on_plan_evict(evicted)
        return fn

    # -- query path ---------------------------------------------------------

    def make_spec(self, seed_terms: Sequence[int], **overrides) -> QuerySpec:
        params = dict(depth=self.depth, topk=self.topk, beam=self.beam,
                      dedup=self.dedup, method=self.method)
        params.update(overrides)
        return QuerySpec(seeds=tuple(int(s) for s in seed_terms), **params)

    def submit(self, query: Union[QuerySpec, Sequence[int]],
               **overrides) -> CoocFuture:
        """Queue a query (a QuerySpec, or seeds completed with the engine
        defaults plus overrides); validation happens here."""
        with tracing.span("cooc.engine.submit"):
            if self._closed:
                raise EngineClosedError(
                    "engine is shut down; create a new CoocEngine over the "
                    "context to serve further queries")
            if isinstance(query, QuerySpec):
                spec = dataclasses.replace(query, **overrides) if overrides \
                    else query
            else:
                spec = self.make_spec(query, **overrides)
            if spec.scope is not None and \
                    spec.scope not in self.ctx.scope_names():
                raise KeyError(
                    f"unknown scope {spec.scope!r}; define/tag it on the "
                    f"context before submitting (defined: "
                    f"{list(self.ctx.scope_names())})")
            req = CoocRequest(self._next_rid, spec,
                              t_submit=time.perf_counter())
            self._next_rid += 1
            self.queue.append(req)
            return CoocFuture(self, req)

    def step(self) -> int:
        """Serve one micro-batch of the head-of-queue plan; returns the
        number of requests resolved (served, or failed onto futures)."""
        if not self.queue:
            return 0
        with tracing.span("cooc.engine.prepare"):
            key = self.queue[0].spec.plan_key
            if key.scope is not None:
                # a scope dropped between submit and step fails exactly
                # that plan's requests, never the engine
                try:
                    scope_mask = self.ctx.scope(key.scope)
                except KeyError as e:
                    poisoned = [r for r in self.queue
                                if r.spec.plan_key == key]
                    self.queue = [r for r in self.queue
                                  if r.spec.plan_key != key]
                    return self._fail_requests(poisoned, e)
            else:
                scope_mask = self.ctx.full_mask()
            admitted: List[CoocRequest] = []
            rest: List[CoocRequest] = []
            for req in self.queue:
                if req.spec.plan_key == key and len(admitted) < self.q_batch:
                    admitted.append(req)
                else:
                    rest.append(req)
            self.queue = rest

            seeds = np.full((self.q_batch, key.beam), -1, np.int32)
            for i, req in enumerate(admitted):
                seeds[i] = req.spec.seed_row()
            executor = self._executor(key)
            dev_seeds = torch.from_numpy(seeds).to(self.ctx.device)
        net = executor(self.ctx, dev_seeds,
                       operands=self.ctx.operands(key.method),
                       scope_mask=scope_mask)
        host = torch.stack([net.src, net.dst, net.weight,
                            net.valid.to(torch.int32)]).cpu().numpy()
        with tracing.span("cooc.engine.resolve"):
            src, dst, w, valid = (a.reshape(self.q_batch, -1) for a in host)
            t_done = time.perf_counter()
            occ = len(admitted)
            self.batch_occupancy.append(occ)
            self.batches_total += 1
            for i, req in enumerate(admitted):
                req.t_done = t_done
                req.result = QueryResult(
                    network=CoocNetwork(src[i], dst[i], w[i], valid[i] != 0),
                    spec=req.spec, epoch=self.ctx.epoch,
                    latency_ms=req.latency_ms, batch_occupancy=occ)
                self.latencies_ms.append(req.latency_ms)
                self.finished.append(req)
                self.served_total += 1
            return occ

    def _fail_requests(self, reqs: List[CoocRequest], error: Exception) -> int:
        t_done = time.perf_counter()
        for r in reqs:
            r.error = error
            r.t_done = t_done
            self.latencies_ms.append(r.latency_ms)
            self.finished.append(r)
        self.failed_total += len(reqs)
        return len(reqs)

    def run_until_drained(self, max_steps: int = 100000) -> List[CoocRequest]:
        for _ in range(max_steps):
            if not self.queue:
                break
            self.step()
        return list(self.finished)

    def shutdown(self, *, drain: bool = True) -> List[CoocRequest]:
        """Close the engine: later submits raise EngineClosedError.
        ``drain=True`` serves every queued request first; ``drain=False``
        resolves each queued future to an EngineClosedError.  Idempotent."""
        self._closed = True
        if drain:
            return self.run_until_drained()
        flushed, self.queue = self.queue, []
        if flushed:
            self._fail_requests(flushed, EngineClosedError(
                "engine shut down (drain=False) before this request was "
                "served"))
        return list(self.finished)

    def query(self, seed_terms: Union[QuerySpec, Sequence[int]],
              **overrides) -> Dict[Tuple[int, int], int]:
        """Submit, drive to completion, return the edge dict."""
        return self.submit(seed_terms, **overrides).result().edges()

    def ingest_docs(self, doc_terms: Sequence[Sequence[int]], *,
                    max_len: int = 64, on_long: str = "raise",
                    doc_window=None, scope=None):
        """Ingest through the context (capacity policy ``on_overflow``).
        ``doc_window`` is the context's sliding-window doc cap, named so
        because the engine's own ``window=`` sizes the stats ring."""
        return self.ctx.ingest_docs(doc_terms, max_len=max_len,
                                    on_overflow=self.on_overflow,
                                    on_long=on_long, window=doc_window,
                                    scope=scope)

    # -- stats --------------------------------------------------------------

    def stats(self) -> EngineStats:
        """Latency/occupancy percentiles over the ring-buffer window."""
        xs = np.fromiter(self.latencies_ms, dtype=np.float64)
        if xs.size == 0:
            return EngineStats(0, 0, 0, 0, 0,
                               compiled_plans=self.compiled_plans,
                               failed_total=self.failed_total,
                               window=self.window,
                               plan_evictions=self.plan_evictions_total)
        p50, p95, p99, p999 = percentile_ms(xs)
        occ = self.batch_occupancy
        return EngineStats(int(xs.size), p50, p95, p99,
                           float(xs.max()), batches=len(occ),
                           mean_occupancy=float(np.mean(occ)) if occ else 0.0,
                           compiled_plans=self.compiled_plans,
                           failed_total=self.failed_total,
                           p999_ms=p999, window=self.window,
                           plan_evictions=self.plan_evictions_total)
