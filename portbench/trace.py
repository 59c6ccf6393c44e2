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
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

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
    """What one traced window recorded: device operations, harness spans."""

    def __init__(self, ops: List[Tuple[str, int, int]],
                 spans: List[Tuple[str, int, int]]):
        win = [s for s in spans if s[0] == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no portbench.window span")
        self.lo, self.hi = win[0][1], win[0][2]
        self.ops = [(n, max(a, self.lo), min(b, self.hi)) for n, a, b in ops
                    if b > self.lo and a < self.hi]
        self.spans = [s for s in spans if s[0] != WINDOW]
        self.busy = _union([(a, b) for _, a, b in self.ops])

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
            ops, spans = [], []
            for e in self._prof.profiler.kineto_results.events():
                name = e.name()
                if _is_device_op(e):
                    ops.append((name[:80], _ns(e, "start"), _ns(e, "end")))
                elif name.startswith("portbench.") and \
                        e.device_type() != torch.autograd.DeviceType.CUDA:
                    spans.append((name, _ns(e, "start"), _ns(e, "end")))
            self.trace = Trace(ops, spans)
        return False

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"portbench.{name}")

    def window(self):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(WINDOW)
