"""Straggler detection & mitigation (host-side runtime policy): a copy of
``repro.train.straggler`` (host-only code, copied so that the port
imports no module of the reference).

On a real pod, SPMD steps are synchronous: one slow host drags the whole
mesh.  The watchdog keeps a rolling step-time distribution; a step beyond
``threshold x median`` flags its host.  Mitigations wired in the trainer:

  * log + mark the host; repeated flags -> report to the elastic manager
    (treated as a soft failure -> mesh shrink, see elastic.py);
  * ``backup_dispatch`` hook: for input-pipeline stragglers, re-issue the
    batch fetch to a standby worker (speculative execution) — on this
    single-process runtime that is simulated, but the trainer calls the
    hook at the real decision point.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    step_time: float
    median: float
    ratio: float


class StragglerWatchdog:
    def __init__(self, window: int = 50, threshold: float = 2.0,
                 min_samples: int = 5,
                 backup_dispatch: Optional[Callable[[int], None]] = None):
        self.times: Deque[float] = collections.deque(maxlen=window)
        self.threshold = threshold
        self.min_samples = min_samples
        self.events: List[StragglerEvent] = []
        self.backup_dispatch = backup_dispatch
        self._t0: Optional[float] = None
        self._step = 0

    def start_step(self, step: int) -> None:
        self._step = step
        self._t0 = time.perf_counter()

    def end_step(self) -> Optional[StragglerEvent]:
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        ev = self.observe(self._step, dt)
        self._t0 = None
        return ev

    def observe(self, step: int, step_time: float) -> Optional[StragglerEvent]:
        med = self._median()
        self.times.append(step_time)
        if med is None:
            return None
        if step_time > self.threshold * med:
            ev = StragglerEvent(step, step_time, med, step_time / med)
            self.events.append(ev)
            if self.backup_dispatch is not None:
                self.backup_dispatch(step)
            return ev
        return None

    def _median(self) -> Optional[float]:
        if len(self.times) < self.min_samples:
            return None
        s = sorted(self.times)
        return s[len(s) // 2]

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {}
        s = sorted(self.times)
        return {
            "median": s[len(s) // 2],
            "p95": s[int(len(s) * 0.95)] if len(s) >= 20 else s[-1],
            "n_straggler_events": float(len(self.events)),
        }
