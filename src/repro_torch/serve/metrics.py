"""Serving observability, copied from ``repro.serve.metrics``: quantile
summaries, per-tenant counters, and a typed snapshot with a plaintext dump
for the serving front end (``serve/server.py``).

:func:`percentile_ms` (``np.percentile``, linear interpolation) is the one
quantile implementation of the port's serving stack: it backs the
ring-buffer :class:`LatencyHistogram`, the engine's stats and the server
metrics, so p50/p99/p999 never disagree between layers.

State is bounded by construction: histograms are fixed-size rings
(O(window) per tenant, never O(queries)), counters are plain cumulative
ints.  :meth:`ServerMetrics.snapshot` returns a frozen
:class:`MetricsSnapshot`; :meth:`ServerMetrics.render` emits the same data
as a plaintext exposition dump (``name{label="value"} number`` lines, one
metric per line), byte for byte the reference's.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

#: the serving stack's canonical quantile set (fractions of 100)
SERVING_QUANTILES: Tuple[float, ...] = (50.0, 95.0, 99.0, 99.9)


def percentile_ms(samples: Sequence[float],
                  qs: Iterable[float] = SERVING_QUANTILES) -> Tuple[float, ...]:
    """``np.percentile`` (linear interpolation) over a sample snapshot;
    0.0 for every requested quantile when ``samples`` is empty."""
    qs = tuple(qs)
    xs = np.asarray(samples, dtype=np.float64)
    if xs.size == 0:
        return tuple(0.0 for _ in qs)
    return tuple(float(v) for v in np.percentile(xs, qs))


@dataclasses.dataclass(frozen=True)
class QuantileSummary:
    """Latency quantiles over one ring-buffer window (all milliseconds)."""
    n: int
    p50_ms: float
    p95_ms: float
    p99_ms: float
    p999_ms: float
    max_ms: float
    window: int = 0         # ring capacity the summary was computed over

    @classmethod
    def of(cls, samples: Sequence[float], *,
           window: int = 0) -> "QuantileSummary":
        xs = np.asarray(samples, dtype=np.float64)
        if xs.size == 0:
            return cls(0, 0.0, 0.0, 0.0, 0.0, 0.0, window=window)
        p50, p95, p99, p999 = percentile_ms(xs)
        return cls(int(xs.size), p50, p95, p99, p999, float(xs.max()),
                   window=window)


class LatencyHistogram:
    """Fixed-window latency ring: O(window) state no matter the traffic."""

    __slots__ = ("_xs", "window")

    def __init__(self, window: int = 4096):
        if int(window) < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self._xs: Deque[float] = deque(maxlen=self.window)

    def observe(self, ms: float) -> None:
        self._xs.append(float(ms))

    def __len__(self) -> int:
        return len(self._xs)

    def summary(self) -> QuantileSummary:
        return QuantileSummary.of(self._xs, window=self.window)


@dataclasses.dataclass
class TenantCounters:
    """Cumulative per-tenant serving counters (mutated in place)."""
    submitted: int = 0        # requests offered (admitted or not)
    served: int = 0           # requests answered with a result
    shed: int = 0             # rejected by admission control
    deadline_misses: int = 0  # expired in queue, or served past deadline
    failed: int = 0           # resolved onto an error
    ingested_docs: int = 0


@dataclasses.dataclass(frozen=True)
class TenantSnapshot:
    counters: TenantCounters
    latency: QuantileSummary


@dataclasses.dataclass(frozen=True)
class MetricsSnapshot:
    """One consistent read of the whole serving layer.

    Totals are cumulative since server start; ``latency`` summarises the
    last ``window`` served requests (all tenants pooled); queue depths are
    gauges (current / high-water).  ``compiled_plans`` / ``plan_evictions``
    mirror the engines' bounded executor caches — the compile-budget
    acceptance metric.
    """
    tenants: Dict[str, TenantSnapshot]
    latency: QuantileSummary
    queue_depth: int
    peak_queue_depth: int
    submitted_total: int
    served_total: int
    shed_total: int
    deadline_miss_total: int
    failed_total: int
    ingested_docs_total: int
    compiled_plans: int
    plan_evictions: int

    @property
    def shed_rate(self) -> float:
        return self.shed_total / max(self.submitted_total, 1)

    @property
    def deadline_miss_rate(self) -> float:
        return self.deadline_miss_total / max(self.submitted_total, 1)


class ServerMetrics:
    """Per-tenant counters + pooled latency ring + queue-depth gauges.

    The server owns one of these; every mutation is a plain counter bump
    or ring append (cheap enough for the submit path).  Engine-owned
    gauges (executor-cache size, eviction total) are passed in at
    :meth:`snapshot` time so the metrics layer never holds an engine
    reference.
    """

    def __init__(self, window: int = 4096):
        self.window = int(window)
        self._tenants: Dict[str, TenantCounters] = {}
        self._tenant_hist: Dict[str, LatencyHistogram] = {}
        self._hist = LatencyHistogram(window)
        self.queue_depth = 0
        self.peak_queue_depth = 0

    def tenant(self, name: str) -> TenantCounters:
        c = self._tenants.get(name)
        if c is None:
            c = self._tenants[name] = TenantCounters()
            self._tenant_hist[name] = LatencyHistogram(self.window)
        return c

    def observe_latency(self, tenant: str, ms: float) -> None:
        self.tenant(tenant)
        self._hist.observe(ms)
        self._tenant_hist[tenant].observe(ms)

    def note_queue_depth(self, depth: int) -> None:
        self.queue_depth = int(depth)
        self.peak_queue_depth = max(self.peak_queue_depth, self.queue_depth)

    def _total(self, field: str) -> int:
        return sum(getattr(c, field) for c in self._tenants.values())

    def snapshot(self, *, compiled_plans: int = 0,
                 plan_evictions: int = 0) -> MetricsSnapshot:
        tenants = {
            name: TenantSnapshot(dataclasses.replace(c),
                                 self._tenant_hist[name].summary())
            for name, c in sorted(self._tenants.items())
        }
        return MetricsSnapshot(
            tenants=tenants,
            latency=self._hist.summary(),
            queue_depth=self.queue_depth,
            peak_queue_depth=self.peak_queue_depth,
            submitted_total=self._total("submitted"),
            served_total=self._total("served"),
            shed_total=self._total("shed"),
            deadline_miss_total=self._total("deadline_misses"),
            failed_total=self._total("failed"),
            ingested_docs_total=self._total("ingested_docs"),
            compiled_plans=int(compiled_plans),
            plan_evictions=int(plan_evictions),
        )

    def render(self, snapshot: Optional[MetricsSnapshot] = None, *,
               compiled_plans: int = 0, plan_evictions: int = 0) -> str:
        """Plaintext exposition dump of a snapshot (freshly taken when not
        given): one ``name[{tenant=...}] value`` line per metric."""
        s = snapshot if snapshot is not None else self.snapshot(
            compiled_plans=compiled_plans, plan_evictions=plan_evictions)
        lines = []

        def emit(name, value, tenant=None):
            label = f'{{tenant="{tenant}"}}' if tenant is not None else ""
            v = f"{value:.6g}" if isinstance(value, float) else str(value)
            lines.append(f"cooc_serve_{name}{label} {v}")

        emit("queue_depth", s.queue_depth)
        emit("peak_queue_depth", s.peak_queue_depth)
        emit("submitted_total", s.submitted_total)
        emit("served_total", s.served_total)
        emit("shed_total", s.shed_total)
        emit("deadline_miss_total", s.deadline_miss_total)
        emit("failed_total", s.failed_total)
        emit("ingested_docs_total", s.ingested_docs_total)
        emit("compiled_plans", s.compiled_plans)
        emit("plan_evictions_total", s.plan_evictions)
        for q, v in (("p50", s.latency.p50_ms), ("p95", s.latency.p95_ms),
                     ("p99", s.latency.p99_ms), ("p999", s.latency.p999_ms),
                     ("max", s.latency.max_ms)):
            emit(f"latency_ms_{q}", float(v))
        for name, t in s.tenants.items():
            c = t.counters
            emit("submitted_total", c.submitted, tenant=name)
            emit("served_total", c.served, tenant=name)
            emit("shed_total", c.shed, tenant=name)
            emit("deadline_miss_total", c.deadline_misses, tenant=name)
            emit("failed_total", c.failed, tenant=name)
            emit("ingested_docs_total", c.ingested_docs, tenant=name)
            emit("latency_ms_p50", float(t.latency.p50_ms), tenant=name)
            emit("latency_ms_p99", float(t.latency.p99_ms), tenant=name)
            emit("latency_ms_p999", float(t.latency.p999_ms), tenant=name)
        return "\n".join(lines) + "\n"
