"""The traced run: ``torch.profiler`` over the measured window, and the
arithmetic that turns its events into busy time, kernel time and gaps.

Rewritten from the port's smoke script (``chip_smoke.py::device_profile``
and ``device_times``: the device's busy time is its operations' time, from
whichever thread launched them).  Here busy time is the union of the
device operations' intervals (kernels, copies, fills), so two operations
that overlap count once; the window is the harness's own
``portbench.window`` span, and every harness span (``portbench.*``,
recorded with ``torch.profiler.record_function``) labels the idle gaps it
covers.

Each device operation keeps its correlation id, and the host call that
launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...: the runtime
or driver event that carries the same id) keeps its start on the host's
clock, so an operation can be charged to the host span it was launched
in, however late the device runs it.
"""
from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

WINDOW = "portbench.window"


def _ns(e, what: str) -> int:
    if hasattr(e, f"{what}_ns"):
        return int(getattr(e, f"{what}_ns")())
    if what == "end":
        return _ns(e, "start") + int(e.duration_us()) * 1000
    return int(e.start_us()) * 1000


def _is_device_op(e) -> bool:
    """A kernel, copy or fill on the device; not the device-side shadow
    of a ``record_function`` span (a user annotation)."""
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    return not (e.name().startswith("portbench.") or (
        hasattr(e, "is_user_annotation") and e.is_user_annotation()))


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _clip(iv, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in iv if b > lo and a < hi]


class Trace:
    """What one traced window recorded: device operations (``(name,
    start_ns, end_ns)``, or with a fourth element, the correlation id of
    the host call that launched it), harness spans, and the host's launch
    calls (``(correlation id, start_ns)``)."""

    def __init__(self, ops: List[tuple], spans: List[Tuple[str, int, int]],
                 launches: Sequence[Tuple[int, int]] = ()):
        win = [s for s in spans if s[0] == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no portbench.window span")
        self.lo, self.hi = win[0][1], win[0][2]
        kept = [(o, max(o[1], self.lo), min(o[2], self.hi)) for o in ops
                if o[2] > self.lo and o[1] < self.hi]
        self.ops = [(o[0], a, b) for o, a, b in kept]
        self.spans = [s for s in spans if s[0] != WINDOW]
        self.busy = _union([(a, b) for _, a, b in self.ops])
        # device seconds in the window by launch (correlation id), and the
        # launch calls of those operations ordered by their host start
        self._by_launch: Dict[int, float] = {}
        for o, a, b in kept:
            if len(o) > 3 and o[3]:
                self._by_launch[o[3]] = self._by_launch.get(o[3], 0.0) \
                    + (b - a) / 1e9
        first: Dict[int, int] = {}
        for c, t in launches:
            if c in self._by_launch:
                first[c] = min(t, first.get(c, t))
        self._launches = sorted((t, c) for c, t in first.items())
        self._launch_ts = [t for t, _ in self._launches]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def op_seconds(self) -> Dict[str, float]:
        per: Dict[str, float] = {}
        for n, a, b in self.ops:
            per[n] = per.get(n, 0.0) + (b - a) / 1e9
        return per

    def span_busy(self, name: str) -> List[Tuple[float, float]]:
        """(span seconds, device busy seconds inside it) of every harness
        span named ``name``."""
        out = []
        for n, a, b in self.spans:
            if n == name:
                busy = sum(y - x for x, y in _clip(self.busy, a, b))
                out.append(((b - a) / 1e9, busy / 1e9))
        return out

    def launched_s(self, spans: Sequence[Tuple[int, int]]) \
            -> Optional[float]:
        """Device seconds of the operations whose launch call started on
        the host inside one of ``spans`` (``(start_ns, end_ns)``, on the
        host's clock, apart from each other), wherever on the device's
        timeline they ran; None where no operation's launch was recorded
        (a trace without correlation ids)."""
        if not self._launches:
            return None
        total = 0.0
        for a, b in spans:
            i = bisect.bisect_left(self._launch_ts, a)
            j = bisect.bisect_left(self._launch_ts, b)
            total += sum(self._by_launch[c] for _, c in self._launches[i:j])
        return total

    def gaps(self) -> List[Tuple[str, float]]:
        """Every idle stretch of the window, labelled by the shortest
        harness span that covers its middle ("host" when none does)."""
        edges = [self.lo] + [x for iv in self.busy for x in iv] + [self.hi]
        out = []
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            cover = [(e - s, n) for n, s, e in self.spans if s <= mid < e]
            out.append((min(cover)[1] if cover else "host", (b - a) / 1e9))
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(self.op_seconds().items(), key=lambda kv: -kv[1])
        gaps = sorted(self.gaps(), key=lambda g: -g[1])
        return {"device_ops": [[n, s] for n, s in ops[:top]],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}


class Recorder:
    """``with Recorder(on) as r: ... with r.window(): ...`` profiles the
    block when ``on``; ``r.span(name)`` marks a harness span; after the
    block ``r.trace`` is the :class:`Trace` (None when off)."""

    def __init__(self, on: bool):
        self.on = on
        self.trace: Optional[Trace] = None
        self._prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is None:
            ops, spans, launches = [], [], []
            for e in self._prof.profiler.kineto_results.events():
                name = e.name()
                # a device operation and the runtime or driver call that
                # launched it carry the same correlation id
                if _is_device_op(e):
                    ops.append((name[:80], _ns(e, "start"), _ns(e, "end"),
                                e.correlation_id()))
                elif e.device_type() == torch.autograd.DeviceType.CUDA:
                    continue
                elif name.startswith("portbench."):
                    spans.append((name, _ns(e, "start"), _ns(e, "end")))
                elif name.startswith("cu") and e.correlation_id():
                    launches.append((e.correlation_id(), _ns(e, "start")))
            self.trace = Trace(ops, spans, launches)
        return False

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"portbench.{name}")

    def window(self):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(WINDOW)
