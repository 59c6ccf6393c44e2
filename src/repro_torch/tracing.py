"""Spans of the program's own phases, on the profiler's clock.

While a ``torch.profiler`` profile records anywhere in the process,
:func:`span` stamps the start and end of the block it wraps and keeps the
finished span in a process-wide ring; at every other time it returns one
shared no-op context and keeps nothing.  There is no switch of its own:
the spans exist to be read beside the profiler's device trace, so they
record exactly while the profiler does.

The profiler's on/off state is read from the module global
``torch.autograd.profiler._is_profiler_enabled``, which every thread
sees; ``torch.autograd._profiler_enabled()`` is thread-local and reads
false on the server's executor threads, where the lanes step and the
ingests run.  Like :data:`repro_torch.kernels.ops.LAUNCHES`, the ring is
one record for the process, updated under one lock.

Stamps come from :func:`now_ns` (``time.time_ns``), the Unix clock the
profiler stamps its host events with, so a span can be set beside the
kernels and copies of the same window.  While recording, each
:func:`span` also opens ``record_function(name)``, so an operator's
exported trace shows the program's phases among the device's work.

:func:`spans` returns the finished spans as ``(name, start_ns, end_ns,
thread, attrs)``, oldest first.  The ring holds :data:`CAPACITY` spans;
past that the oldest is overwritten and counted in :func:`dropped`.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Tuple

import torch.autograd.profiler as _profiler

#: spans the ring holds: a 30 s window of the busiest serving traffic
#: opens a few tens of thousands
CAPACITY = 1 << 17

#: what :func:`span` returns while nothing records
NO_SPAN = contextlib.nullcontext()

Span = Tuple[str, int, int, int, Dict]

_LOCK = threading.Lock()
_RING: Deque[Span] = deque(maxlen=CAPACITY)
_DROPPED = 0


def now_ns() -> int:
    """The spans' clock: Unix time in ns, as the profiler stamps."""
    return time.time_ns()


def _keep(name: str, start_ns: int, end_ns: int, attrs: Dict) -> None:
    global _DROPPED
    item = (name, start_ns, end_ns, threading.get_ident(), attrs)
    with _LOCK:
        if len(_RING) == _RING.maxlen:
            _DROPPED += 1
        _RING.append(item)


class _Span:
    __slots__ = ("name", "attrs", "start", "annotation")

    def __init__(self, name: str, attrs: Dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.annotation = _profiler.record_function(self.name)
        self.annotation.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.annotation.__exit__(*exc)
        _keep(self.name, self.start, end, self.attrs)
        return False


def span(name: str, **attrs):
    """``with span(name, **attrs):`` records the block while a profile
    records; otherwise it is :data:`NO_SPAN`."""
    if not _profiler._is_profiler_enabled:
        return NO_SPAN
    return _Span(name, attrs)


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Keep a span whose start was stamped earlier with :func:`now_ns`
    (a request's wait in a queue), while a profile records."""
    if _profiler._is_profiler_enabled:
        _keep(name, start_ns, end_ns, attrs)


def spans() -> List[Span]:
    """The finished spans, oldest first."""
    with _LOCK:
        return list(_RING)


def dropped() -> int:
    """Spans overwritten since the last :func:`clear`."""
    return _DROPPED


def clear() -> None:
    global _DROPPED
    with _LOCK:
        _RING.clear()
        _DROPPED = 0
