"""Admission control and the live per-plan step-time model, copied from
``repro.serve.admission`` (pure host code, the same arithmetic).

The server front end (``serve/server.py``) consults this module at two
points:

* **On submit** — :class:`AdmissionController` decides admit vs shed from
  two bounded signals: current queue depth against ``max_queue_depth``,
  and the *estimated wait* for a new arrival against ``max_wait_ms``.
  Shedding is explicit (the caller gets a typed
  :class:`AdmissionDecision` naming the reason), never silent, so a
  client under overload sees an immediate reject instead of a slow
  deadline miss.

* **On flush** — :class:`StepTimeModel` predicts how long the next engine
  step for a given executable will take, from a ring of recently
  observed step times.  The batcher uses this to decide how long it can
  linger accumulating occupancy before the oldest deadline is at risk.

Cold plans are the sharp edge: a plan key the model has never seen has
no executor in the engine's cache yet.  In the port an executor is a plain
callable, so nothing is compiled; the first step of a new plan pays what
its new shapes cost (fresh allocations in the caching allocator, and the
kernel libraries' build if no earlier plan loaded them).  Its true cost is
unknown until it has run once, so the model returns a deliberately
pessimistic ``cold_ms`` prior for unseen keys, which makes the estimated
wait blow past ``max_wait_ms`` and *shed* the traffic behind an unknown
step instead of letting it sit in queue and miss its deadline.  This is
what turns a hostile diverse-plan burst into bounded rejects.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, Hashable, Iterable, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Static budgets for one serving lane.

    ``max_queue_depth``: hard bound on requests queued (not yet stepped).
    ``max_wait_ms``: shed when the estimated wait for a new arrival
    exceeds this.  ``None`` disables that signal.
    """
    max_queue_depth: int = 64
    max_wait_ms: Optional[float] = None

    def __post_init__(self):
        if self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {self.max_queue_depth}")
        if self.max_wait_ms is not None and self.max_wait_ms <= 0:
            raise ValueError(
                f"max_wait_ms must be positive, got {self.max_wait_ms}")


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    admitted: bool
    reason: str = "ok"              # "ok" | "queue_full" | "est_wait"
    est_wait_ms: float = 0.0

    def __bool__(self) -> bool:
        return self.admitted


class StepTimeModel:
    """Ring of recent per-executable step times with a cold-plan prior.

    ``observe(key, ms)`` after each engine step; ``predict(key)`` returns
    the mean of the last ``window`` observations, or ``cold_ms`` for a
    key never stepped (unseen key ⇒ its step cost is unknown).
    """

    def __init__(self, *, window: int = 32, cold_ms: float = 2000.0):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self.cold_ms = float(cold_ms)
        self._rings: Dict[Hashable, Deque[float]] = {}

    def observe(self, key: Hashable, ms: float) -> None:
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = deque(maxlen=self.window)
        ring.append(float(ms))

    def seen(self, key: Hashable) -> bool:
        return bool(self._rings.get(key))

    def forget(self, key: Hashable) -> None:
        """Drop a key's history (call when its executor is LRU-evicted:
        the next step is a first step again, so warm observations would
        lie)."""
        self._rings.pop(key, None)

    def predict(self, key: Hashable) -> float:
        ring = self._rings.get(key)
        if not ring:
            return self.cold_ms
        return sum(ring) / len(ring)


def estimate_wait_ms(pending_keys: Iterable[Hashable],
                     model: StepTimeModel,
                     *,
                     q_batch: int,
                     inflight_key: Optional[Hashable] = None,
                     inflight_elapsed_ms: float = 0.0) -> float:
    """Estimated queueing delay for a request arriving *now*.

    Sums, per distinct executable already queued ahead of the arrival,
    ``ceil(n / q_batch) * predict(key)`` (the engine steps one plan per
    flush, ``q_batch`` queries per step), plus the predicted remainder of
    any step currently in flight.  An in-flight *cold* step's remainder
    is floored at its full prediction — a first step's true cost is
    unknown from elapsed time alone, and underestimating it is what lets
    traffic pile up behind it.
    """
    counts: Dict[Hashable, int] = {}
    for k in pending_keys:
        counts[k] = counts.get(k, 0) + 1
    total = 0.0
    for key, n in counts.items():
        total += math.ceil(n / max(q_batch, 1)) * model.predict(key)
    if inflight_key is not None:
        pred = model.predict(inflight_key)
        if model.seen(inflight_key):
            total += max(pred - inflight_elapsed_ms, 0.0)
        else:
            total += pred
    return total


class AdmissionController:
    """Applies an :class:`AdmissionPolicy` and counts what it sheds."""

    def __init__(self, policy: AdmissionPolicy):
        self.policy = policy
        self.admitted_total = 0
        self.shed_total = 0
        self.shed_queue_full = 0
        self.shed_est_wait = 0

    def decide(self, *, queue_depth: int,
               est_wait_ms: float = 0.0) -> AdmissionDecision:
        if queue_depth >= self.policy.max_queue_depth:
            self.shed_total += 1
            self.shed_queue_full += 1
            return AdmissionDecision(False, "queue_full", est_wait_ms)
        if (self.policy.max_wait_ms is not None
                and est_wait_ms > self.policy.max_wait_ms):
            self.shed_total += 1
            self.shed_est_wait += 1
            return AdmissionDecision(False, "est_wait", est_wait_ms)
        self.admitted_total += 1
        return AdmissionDecision(True, "ok", est_wait_ms)

    def counters(self) -> Tuple[int, int, int, int]:
        return (self.admitted_total, self.shed_total,
                self.shed_queue_full, self.shed_est_wait)
