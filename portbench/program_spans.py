"""The program's own spans in a traced window, and the arithmetic of the
``program_span`` metrics that read them.

The program records its phases (``repro_torch.tracing``) while a profile
records, stamped on the profiler's own clock, so the traced window is the
trace's ``[lo, hi)`` and every span is clipped to it.  Three readings:

* host time: the mean, or the nearest-rank 95th percentile, of a span's
  duration, or its sum over the window per engine step;
* device idle inside a span: each idle stretch of the window goes to the
  innermost program span that covers its middle, the rule
  :meth:`portbench.trace.Trace.gaps` applies to the harness's spans.

* device time launched inside a span: the device time of every
  operation whose launch call (the host event with its correlation id)
  started inside a span of the name, wherever on the device's timeline
  it ran (:meth:`portbench.trace.Trace.launched_s`).  It reads the span,
  not kernel names, so it holds whatever the span's code launches.

Every reading is None where it cannot be trusted or has nothing to read:
a program that keeps no spans, a ring that overflowed (spans of the
window may be lost), no span of the name in the window, or (for idle and
launched device time) a trace with no device operation, or none tied to
its launch.
"""
from __future__ import annotations

import heapq
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

#: (name, start_ns, end_ns)
Span = Tuple[str, int, int]

#: one engine step opens one of these
STEP = "cooc.engine.prepare"


def _ring():
    """(spans, dropped) of the program's recorder, or None where the
    program has none."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.spans(), tracing.dropped()


def clip(spans, lo: int, hi: int) -> List[Span]:
    """The spans (``(name, start_ns, end_ns, ...)``) that overlap
    ``[lo, hi)``, clipped to it."""
    return [(s[0], max(s[1], lo), min(s[2], hi)) for s in spans
            if s[2] > lo and s[1] < hi]


def window_spans(obs: Mapping) -> Optional[List[Span]]:
    """The program's spans in the traced window of ``obs``, clipped to
    it; None where the run was not traced, the program keeps no spans or
    its ring dropped some."""
    trace = obs.get("trace")
    ring = _ring()
    if trace is None or ring is None or ring[1]:
        return None
    return clip(ring[0], trace.lo, trace.hi)


def _durations_ms(obs: Mapping, name: str) -> Optional[List[float]]:
    spans = window_spans(obs)
    if spans is None:
        return None
    out = [(b - a) / 1e6 for n, a, b in spans if n == name]
    return out or None


def mean_ms(obs: Mapping, name: str) -> Optional[float]:
    """Mean duration of the spans ``name``, ms."""
    d = _durations_ms(obs, name)
    return sum(d) / len(d) if d else None


def p95_ms(obs: Mapping, name: str) -> Optional[float]:
    """Nearest-rank 95th percentile of the durations of ``name``, ms."""
    d = _durations_ms(obs, name)
    if not d:
        return None
    d.sort()
    return d[max(0, int(math.ceil(0.95 * len(d))) - 1)]


def per_step_ms(obs: Mapping, name: str) -> Optional[float]:
    """The spans ``name``'s total duration over the engine steps in the
    window (one :data:`STEP` span each), ms."""
    d = _durations_ms(obs, name)
    steps = _durations_ms(obs, STEP)
    if not d or not steps:
        return None
    return sum(d) / len(steps)


def idle_by_span(trace, spans: Sequence[Span]) -> Dict[Optional[str], float]:
    """Seconds of the window's idle stretches by the name of the shortest
    span covering each stretch's middle (None: no span covers it)."""
    edges = [trace.lo] + [x for iv in trace.busy for x in iv] + [trace.hi]
    order = sorted(spans, key=lambda s: s[1])
    active: List[Tuple[int, str, int]] = []      # (length, name, end)
    out: Dict[Optional[str], float] = {}
    i = 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        while i < len(order) and order[i][1] <= mid:
            n, s, e = order[i][:3]
            heapq.heappush(active, (e - s, n, e))
            i += 1
        while active and active[0][2] <= mid:
            heapq.heappop(active)
        name = active[0][1] if active else None
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out


def idle_ms_per_network(obs: Mapping, name: str) -> Optional[float]:
    """Device idle inside the spans ``name`` over the networks built in
    the window, ms."""
    trace, nets = obs.get("trace"), obs.get("networks")
    spans = window_spans(obs)
    if not spans or not nets or not trace.busy or \
            not any(n == name for n, _, _ in spans):
        return None
    return 1e3 * idle_by_span(trace, spans).get(name, 0.0) / nets


def launched_ms_per_network(obs: Mapping, name: str) -> Optional[float]:
    """Device time of the operations launched inside the spans ``name``
    over the networks built in the window, ms."""
    trace, nets = obs.get("trace"), obs.get("networks")
    spans = window_spans(obs)
    if not spans or not nets:
        return None
    mine = [(a, b) for n, a, b in spans if n == name]
    if not mine:
        return None
    s = trace.launched_s(mine)
    return None if not s else 1e3 * s / nets
