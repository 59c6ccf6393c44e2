"""CoocServer — asyncio multi-tenant serving front end over CoocEngine,
mirroring ``repro.serve.server`` (the same names, fields, defaults and
batching arithmetic).

The engine solves *throughput* (plan-aware micro-batching, one cached
executor per plan); this layer solves *service*: who may query what, what
happens under overload, and when a batch should stop waiting for more
occupancy because a deadline is at risk.

* **Tenancy.**  Each :class:`TenantConfig` maps a tenant either onto a
  named scope of the server's shared :class:`QueryContext`
  (cheap isolation: one index, per-tenant doc bitmaps, shared
  executors) or onto a dedicated context of its own (hard isolation:
  separate index, separate engine, separate admission).  Tenants pinned
  to a scope cannot query outside it — a spec naming a different scope
  resolves to a ``forbidden_scope`` error response, never to data.

* **Admission control.**  Every submit consults
  :class:`~repro_torch.serve.admission.AdmissionController` with the lane's
  live queue depth and the *estimated wait* from the per-plan step-time
  model.  Over budget ⇒ the request is **shed** with an immediate typed
  response — bounded queues by construction, and the cold-plan prior
  (unseen plan ⇒ assume a slow first step) sheds the traffic that would
  otherwise pile up behind a burst of never-seen plans.

* **Deadline-aware micro-batching.**  The per-lane batcher serves the
  head-of-queue plan, FIFO.  While the batch is short of ``q_batch`` it
  lingers for more same-plan arrivals, but only while
  ``oldest deadline − now − predicted step − margin`` stays positive —
  occupancy is traded against p99 using live step-time observations, and
  the flush happens early the moment the oldest request's deadline
  approaches.  Requests already expired in queue resolve as
  ``deadline_miss`` without touching the device.

Blocking engine work (step, ingest) runs in the default executor under a
per-lane async lock, so the event loop stays responsive and a lane never
interleaves a step with an ingest epoch bump.  Each lane's engine lives on
its context's device; two lanes step from two executor threads, each
launching its kernels on that device's current stream.

While a profile records, each request's wait from its enqueue to the
batcher taking (or expiring) it is a ``cooc.server.queue`` span of
:mod:`repro_torch.tracing`, and each lane step a ``cooc.server.lane_step``
span: the stamps the step-time model's ``step_ms`` comes from.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Mapping, Optional, Sequence, Union

from repro_torch import tracing
from repro_torch.core.query import (
    QueryResult,
    QuerySpec,
    canonical_exec_key,
    canonicalize_request,
)
from repro_torch.core.query_context import QueryContext
from repro_torch.core.snapshot import load_context
from repro_torch.device import resolve_device
from repro_torch.serve.admission import (
    AdmissionController,
    AdmissionPolicy,
    StepTimeModel,
    estimate_wait_ms,
)
from repro_torch.serve.cooc_engine import CoocEngine
from repro_torch.serve.metrics import MetricsSnapshot, ServerMetrics


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant: a name, plus scope-pinning or a dedicated context.

    ``scope``: pin the tenant to this named scope of the shared context
    (its requests are forced into the scope; naming another scope is
    forbidden).  ``ctx``: give the tenant its own QueryContext — its own
    lane, engine and admission queue (mutually exclusive with ``scope``).
    ``deadline_ms`` overrides the server default deadline;
    ``policy`` overrides the server default admission policy (dedicated-
    context tenants only — scoped tenants share the common lane's queue).
    """
    name: str
    scope: Optional[str] = None
    ctx: Optional[QueryContext] = None
    deadline_ms: Optional[float] = None
    policy: Optional[AdmissionPolicy] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.scope is not None and self.ctx is not None:
            raise ValueError(
                f"tenant {self.name!r}: scope and ctx are mutually "
                "exclusive (scope pins to the shared context)")
        if self.policy is not None and self.ctx is None:
            raise ValueError(
                f"tenant {self.name!r}: per-tenant admission policy needs "
                "a dedicated ctx; scoped tenants share the common lane")


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Engine defaults + serving budgets for a CoocServer."""
    depth: int = 3
    topk: int = 16
    beam: int = 32
    q_batch: int = 8
    method: str = "gemm"
    dedup: bool = True
    compile_budget: Optional[int] = 8       # LRU bound per lane engine
    policy: AdmissionPolicy = AdmissionPolicy()
    default_deadline_ms: float = 2000.0
    linger_ms: float = 5.0                  # max wait for more occupancy
    margin_ms: float = 10.0                 # deadline safety margin
    metrics_window: int = 4096
    model_window: int = 32                  # step-time ring per executable
    cold_ms: float = 2000.0                 # unseen-plan prior


@dataclasses.dataclass(frozen=True)
class ServeResponse:
    """Typed outcome of one submitted request.

    ``status``: ``"ok"`` | ``"shed"`` | ``"deadline_miss"`` | ``"error"``.
    ``deadline_miss`` may still carry the result (served late); shed and
    error responses never do.  ``reason`` qualifies non-ok statuses
    (``queue_full`` / ``est_wait`` / ``expired_in_queue`` / ``served_late``
    / ``forbidden_scope`` / an error string).
    """
    tenant: str
    status: str
    reason: str = ""
    result: Optional[QueryResult] = None
    latency_ms: float = 0.0
    est_wait_ms: float = 0.0

    @property
    def ok(self) -> bool:
        return self.status == "ok"


@dataclasses.dataclass
class _Pending:
    tenant: str
    spec: QuerySpec
    deadline_ts: float              # absolute monotonic deadline
    t_enqueue: float
    future: "asyncio.Future[ServeResponse]"
    t_enqueue_ns: int               # the enqueue on the spans' clock


class _Lane:
    """One serving lane: an engine + pending queue + batcher state.

    The shared context gets one lane (all scoped/unscoped tenants);
    each dedicated-context tenant gets its own.
    """

    def __init__(self, name: str, engine: CoocEngine,
                 policy: AdmissionPolicy, cfg: ServerConfig):
        self.name = name
        self.engine = engine
        self.admission = AdmissionController(policy)
        self.model = StepTimeModel(window=cfg.model_window,
                                   cold_ms=cfg.cold_ms)
        engine.on_plan_evict = self.model.forget
        self.pending: Deque[_Pending] = deque()
        self.event = asyncio.Event()
        self.lock = asyncio.Lock()      # serialises step vs ingest
        self.inflight_key = None
        self.inflight_start = 0.0
        self.task: Optional[asyncio.Task] = None

    def estimate_wait_ms(self) -> float:
        now = time.monotonic()
        elapsed = (now - self.inflight_start) * 1e3 if self.inflight_key else 0.0
        return estimate_wait_ms(
            (canonical_exec_key(p.spec.plan_key) for p in self.pending),
            self.model, q_batch=self.engine.q_batch,
            inflight_key=self.inflight_key, inflight_elapsed_ms=elapsed)


class CoocServer:
    """Async multi-tenant front end: admission control + deadline-aware
    micro-batching over one or more :class:`CoocEngine` lanes.

    Lifecycle: construct → ``await start()`` → ``await submit(...)`` /
    ``await ingest(...)`` → ``await stop()``.  ``submit`` resolves when
    the request is served, shed, or failed — never hangs: ``stop()``
    drains (or flushes) every pending future.
    """

    def __init__(self, ctx: QueryContext,
                 tenants: Sequence[TenantConfig] = (),
                 config: ServerConfig = ServerConfig()):
        self.cfg = config
        self.ctx = ctx
        self.metrics = ServerMetrics(window=config.metrics_window)
        self.tenants: Dict[str, TenantConfig] = {}
        self._lanes: Dict[str, _Lane] = {}
        self._tenant_lane: Dict[str, str] = {}
        self._shared = self._make_lane("shared", ctx, config.policy)
        for t in tenants:
            self.add_tenant(t)
        self._started = False
        self._stopping = False

    @classmethod
    def from_snapshot(cls, path: str, *,
                      tenants: Sequence[TenantConfig] = (),
                      config: ServerConfig = ServerConfig(),
                      device="cuda", mesh=None, cold_store=None,
                      verify: bool = True) -> "CoocServer":
        """Warm-start a server from a durable snapshot
        (:func:`repro_torch.core.save_context` / ``CoocIndex.save``, or
        the reference's, which write the same format): the shared context
        — packed index, streaming ring, scope bitmaps, cold tier — is
        restored bit-exactly onto ``device`` and the server is ready to
        serve the moment ``start()`` returns, instead of re-ingesting the
        corpus from raw text.  Runs on the card unless ``device="cpu"``;
        without a card it raises before reading the snapshot.  ``mesh``
        restores the context onto a query mesh (whose first device
        ``device`` names): every lane's engine then serves sharded."""
        dev = resolve_device(device)
        ctx = load_context(path, device=dev, mesh=mesh,
                           cold_store=cold_store, verify=verify)
        return cls(ctx, tenants=tenants, config=config)

    def _make_lane(self, name: str, ctx: QueryContext,
                   policy: AdmissionPolicy) -> _Lane:
        eng = CoocEngine(
            ctx, device=ctx.device, depth=self.cfg.depth, topk=self.cfg.topk,
            beam=self.cfg.beam, q_batch=self.cfg.q_batch,
            method=self.cfg.method, dedup=self.cfg.dedup,
            compile_budget=self.cfg.compile_budget)
        lane = _Lane(name, eng, policy, self.cfg)
        self._lanes[name] = lane
        return lane

    def add_tenant(self, t: TenantConfig) -> None:
        if t.name in self.tenants:
            raise ValueError(f"tenant {t.name!r} already registered")
        self.tenants[t.name] = t
        if t.ctx is not None:
            self._make_lane(t.name, t.ctx, t.policy or self.cfg.policy)
            self._tenant_lane[t.name] = t.name
        else:
            self._tenant_lane[t.name] = "shared"
        self.metrics.tenant(t.name)     # counters exist even if never used

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "CoocServer":
        if self._started:
            return self
        self._started = True
        self._stopping = False
        for lane in self._lanes.values():
            lane.task = asyncio.create_task(
                self._lane_loop(lane), name=f"cooc-lane-{lane.name}")
        return self

    async def stop(self, *, drain: bool = True) -> None:
        """Stop serving.  ``drain=True`` serves everything still queued
        first; ``drain=False`` resolves queued futures as shutdown errors.
        Either way no future is left hanging, and the lane engines are
        shut down (subsequent engine submits raise EngineClosedError).
        """
        if not self._started:
            return
        self._stopping = True
        if not drain:
            for lane in self._lanes.values():
                while lane.pending:
                    p = lane.pending.popleft()
                    self._resolve(lane, p, ServeResponse(
                        p.tenant, "error", reason="server_shutdown"))
        for lane in self._lanes.values():
            lane.event.set()
        for lane in self._lanes.values():
            if lane.task is not None:
                await lane.task
                lane.task = None
        for lane in self._lanes.values():
            async with lane.lock:
                await asyncio.get_running_loop().run_in_executor(
                    None, lambda eng=lane.engine: eng.shutdown(drain=drain))
        self._started = False

    # -- request path --------------------------------------------------------

    def _resolve_spec(self, tenant: TenantConfig,
                      request: Union[QuerySpec, Mapping, Sequence[int]],
                      ) -> QuerySpec:
        defaults = dict(depth=self.cfg.depth, topk=self.cfg.topk,
                        beam=self.cfg.beam, dedup=self.cfg.dedup,
                        method=self.cfg.method)
        if tenant.scope is not None:
            defaults["scope"] = tenant.scope
        spec = canonicalize_request(request, defaults=defaults)
        if tenant.scope is not None and spec.scope != tenant.scope:
            raise PermissionError(
                f"tenant {tenant.name!r} is pinned to scope "
                f"{tenant.scope!r}; request named scope {spec.scope!r}")
        return spec

    async def submit(self, tenant: str,
                     request: Union[QuerySpec, Mapping, Sequence[int]],
                     *, deadline_ms: Optional[float] = None) -> ServeResponse:
        """Serve one request for ``tenant``; resolves when the request is
        served, shed, or failed.  Per-request problems (forbidden scope,
        overload, expiry, execution error) come back as typed responses —
        only misuse (unknown tenant, server not started) raises.
        """
        if not self._started or self._stopping:
            raise RuntimeError("server is not running (call start(), and "
                               "submit before stop())")
        t = self.tenants.get(tenant)
        if t is None:
            raise KeyError(f"unknown tenant {tenant!r}; registered: "
                           f"{sorted(self.tenants)}")
        counters = self.metrics.tenant(tenant)
        counters.submitted += 1
        lane = self._lanes[self._tenant_lane[tenant]]
        try:
            spec = self._resolve_spec(t, request)
        except PermissionError as e:
            counters.failed += 1
            return ServeResponse(tenant, "error", reason="forbidden_scope:"
                                 + str(e))
        except (ValueError, TypeError) as e:
            counters.failed += 1
            return ServeResponse(tenant, "error", reason=f"bad_request: {e}")

        est = lane.estimate_wait_ms()
        decision = lane.admission.decide(
            queue_depth=len(lane.pending), est_wait_ms=est)
        if not decision:
            counters.shed += 1
            self.metrics.note_queue_depth(len(lane.pending))
            return ServeResponse(tenant, "shed", reason=decision.reason,
                                 est_wait_ms=decision.est_wait_ms)

        now = time.monotonic()
        budget = deadline_ms if deadline_ms is not None else (
            t.deadline_ms if t.deadline_ms is not None
            else self.cfg.default_deadline_ms)
        p = _Pending(tenant, spec, now + budget / 1e3, now,
                     asyncio.get_running_loop().create_future(),
                     tracing.now_ns())
        lane.pending.append(p)
        self.metrics.note_queue_depth(len(lane.pending))
        lane.event.set()
        return await p.future

    async def ingest(self, tenant: str, doc_terms: Sequence[Sequence[int]],
                     **kwargs) -> Sequence[int]:
        """Real-time ingest on the tenant's lane (scope-tagged for scoped
        tenants), serialised against that lane's query steps."""
        t = self.tenants.get(tenant)
        if t is None:
            raise KeyError(f"unknown tenant {tenant!r}")
        lane = self._lanes[self._tenant_lane[tenant]]
        if t.scope is not None:
            kwargs.setdefault("scope", t.scope)
        async with lane.lock:
            slots = await asyncio.get_running_loop().run_in_executor(
                None, lambda: lane.engine.ingest_docs(doc_terms, **kwargs))
        self.metrics.tenant(tenant).ingested_docs += len(doc_terms)
        return slots

    # -- batcher -------------------------------------------------------------

    def _resolve(self, lane: _Lane, p: _Pending, resp: ServeResponse) -> None:
        c = self.metrics.tenant(p.tenant)
        if resp.status == "ok":
            c.served += 1
        elif resp.status == "deadline_miss":
            c.deadline_misses += 1
            if resp.result is not None:
                c.served += 1           # late but answered
        elif resp.status == "error":
            c.failed += 1
        if resp.latency_ms > 0:
            self.metrics.observe_latency(p.tenant, resp.latency_ms)
        if not p.future.done():
            p.future.set_result(resp)

    def _expire(self, lane: _Lane) -> None:
        now = time.monotonic()
        kept = deque()
        while lane.pending:
            p = lane.pending.popleft()
            if p.deadline_ts <= now:
                tracing.record("cooc.server.queue", p.t_enqueue_ns,
                               tracing.now_ns())
                self._resolve(lane, p, ServeResponse(
                    p.tenant, "deadline_miss", reason="expired_in_queue",
                    latency_ms=(now - p.t_enqueue) * 1e3))
            else:
                kept.append(p)
        lane.pending = kept

    async def _lane_loop(self, lane: _Lane) -> None:
        loop = asyncio.get_running_loop()
        while True:
            if not lane.pending:
                if self._stopping:
                    return
                lane.event.clear()
                await lane.event.wait()
                continue
            self._expire(lane)
            if not lane.pending:
                continue

            head = lane.pending[0]
            key = head.spec.plan_key
            exec_key = canonical_exec_key(key)
            batch = [p for p in lane.pending if p.spec.plan_key == key]
            batch = batch[:lane.engine.q_batch]

            now = time.monotonic()
            pred_s = lane.model.predict(exec_key) / 1e3
            slack_s = (min(p.deadline_ts for p in batch) - now - pred_s
                       - self.cfg.margin_ms / 1e3)
            linger_s = (head.t_enqueue + self.cfg.linger_ms / 1e3) - now
            if (len(batch) < lane.engine.q_batch and not self._stopping
                    and slack_s > 0 and linger_s > 0):
                # short of full occupancy and the oldest deadline is safe:
                # linger for more same-plan arrivals, then re-plan
                lane.event.clear()
                try:
                    await asyncio.wait_for(lane.event.wait(),
                                           timeout=min(slack_s, linger_s))
                except asyncio.TimeoutError:
                    pass
                continue

            taken_ns = tracing.now_ns()
            for p in batch:
                lane.pending.remove(p)
                tracing.record("cooc.server.queue", p.t_enqueue_ns, taken_ns)
            self.metrics.note_queue_depth(len(lane.pending))
            lane.inflight_key = exec_key
            lane.inflight_start = time.monotonic()

            def _run_batch(reqs=batch):
                # submit + drain + RESOLVE all inside the executor: a
                # CoocFuture.result() drives engine.step() while
                # unresolved, i.e. it launches device work — it must never
                # run on the event loop (cooclint COOC003 enforces this
                # lexically: no .result() in the async body below).
                # step_ms is the steps' true time: each step ends in a
                # blocking copy of its network to the host.  Its two
                # stamps are also the lane step's span.
                futs = []
                for p in reqs:
                    try:
                        futs.append((p, lane.engine.submit(p.spec)))
                    except Exception as e:           # e.g. unknown scope
                        futs.append((p, e))
                t0 = tracing.now_ns()
                lane.engine.run_until_drained()
                t1 = tracing.now_ns()
                tracing.record("cooc.server.lane_step", t0, t1, n=len(reqs))
                step_ms = (t1 - t0) / 1e6
                outs = []
                for p, fut in futs:
                    if isinstance(fut, Exception):
                        outs.append((p, None, fut))
                        continue
                    try:
                        outs.append((p, fut.result(), None))
                    except Exception as e:
                        outs.append((p, None, e))
                return outs, step_ms

            async with lane.lock:
                outs, step_ms = await loop.run_in_executor(None, _run_batch)
            lane.model.observe(exec_key, step_ms)
            lane.inflight_key = None

            t_done = time.monotonic()
            for p, result, exc in outs:
                latency_ms = (t_done - p.t_enqueue) * 1e3
                if exc is not None:
                    self._resolve(lane, p, ServeResponse(
                        p.tenant, "error", reason=str(exc),
                        latency_ms=latency_ms))
                    continue
                if t_done > p.deadline_ts:
                    self._resolve(lane, p, ServeResponse(
                        p.tenant, "deadline_miss", reason="served_late",
                        result=result, latency_ms=latency_ms))
                else:
                    self._resolve(lane, p, ServeResponse(
                        p.tenant, "ok", result=result,
                        latency_ms=latency_ms))

    # -- observability -------------------------------------------------------

    def snapshot(self) -> MetricsSnapshot:
        """One consistent read: per-tenant counters + pooled latency
        quantiles + the summed executor-cache gauges across lanes."""
        return self.metrics.snapshot(
            compiled_plans=sum(l.engine.compiled_plans
                               for l in self._lanes.values()),
            plan_evictions=sum(l.engine.plan_evictions_total
                               for l in self._lanes.values()))

    def render_metrics(self) -> str:
        return self.metrics.render(self.snapshot())

    def queue_depth(self, tenant: Optional[str] = None) -> int:
        if tenant is None:
            return sum(len(l.pending) for l in self._lanes.values())
        return len(self._lanes[self._tenant_lane[tenant]].pending)
