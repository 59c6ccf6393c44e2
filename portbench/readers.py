"""The arithmetic of the per-layer metrics.  Each metric's own file under
``metrics/`` picks what it reads; every function here takes the run's
observations (``obs``, see ``systems/*.py``) and returns the number, or
None where the run recorded nothing to read."""
from __future__ import annotations

import re
from typing import Mapping, Optional, Sequence

from portbench import roofline

#: the device functions of the fused BFS level step (kernel 2,
#: ``kernels/csrc/level_step.cu`` and its compaction in ``postings.cu``)
LEVEL_STEP_KERNELS = ("compact_kernel", "level_tiles", "level_merge")
#: the device functions of the co-occurrence kernel (kernel 3,
#: ``kernels/csrc/cooccur.cu``: its TMA path and its fallback)
COOCCUR_KERNELS = ("cooccur_wgmma", "cooccur_bytes")


def _kernel_s(trace, names: Sequence[str]) -> float:
    pat = re.compile(r"(^|[\s:])(" + "|".join(names) + r")\s*[(<]")
    return sum(s for n, s in trace.op_seconds().items() if pat.search(n))


def shed_share(obs: Mapping) -> Optional[float]:
    """Shed, missed and failed requests over those offered, %."""
    st = obs.get("statuses")
    if not st:
        return None
    return 100.0 * sum(1 for s in st if s != "ok") / len(st)


def mean_occupancy(obs: Mapping) -> Optional[float]:
    occ = obs.get("occupancy")
    return sum(occ) / len(occ) if occ else None


def launches_per_batch(obs: Mapping) -> Optional[float]:
    batches = obs.get("batches")
    if not batches:
        return None
    return sum(obs["launches"].values()) / len(batches)


def launches_per_network(obs: Mapping) -> Optional[float]:
    n = obs.get("networks")
    if not n:
        return None
    return obs["launches"].get("cooccur_counts", 0) / n


def _span_host_ms(obs: Mapping, name: str) -> Optional[float]:
    """Mean host time of the harness spans ``name``: each span less the
    device's busy time inside it, ms."""
    trace = obs.get("trace")
    if trace is None:
        return None
    spans = trace.span_busy(f"portbench.{name}")
    if not spans:
        return None
    return 1e3 * sum(s - b for s, b in spans) / len(spans)


def step_host_ms(obs: Mapping) -> Optional[float]:
    """Host time of an engine step, ms."""
    return _span_host_ms(obs, "step")


def ingest_host_ms(obs: Mapping) -> Optional[float]:
    """Host time of an awaited ingest (pack, retire, spill encode, the
    cold store's write), ms."""
    return _span_host_ms(obs, "ingest")


def idle_share(obs: Mapping) -> Optional[float]:
    """Share of the traced window in which no device operation ran, %."""
    trace = obs.get("trace")
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def bfs_roofline(obs: Mapping) -> Optional[float]:
    """The BFS levels' least time (``roofline.least_s`` per served batch
    and level, from the reference's frontiers) over the level-step
    kernel's device time in the same window, %."""
    trace, stats, shape = obs.get("trace"), obs.get("bfs_stats"), \
        obs.get("shape")
    if trace is None or not stats or not shape:
        return None
    kernel = _kernel_s(trace, LEVEL_STEP_KERNELS)
    if kernel <= 0:
        return None
    rates = roofline.peaks()
    least = sum(roofline.least_s(
        rows=s["rows"], nonzero_words=s["nonzero_words"],
        words=s["active_words"], mask_words=s["rows"] * shape["n_words"],
        n_docs=shape["n_docs"], vocab=shape["vocab"], k=shape["k"],
        rates=rates)[0] for s in stats)
    return 100.0 * least / kernel


def network_roofline(obs: Mapping) -> Optional[float]:
    """The whole network's least time, once per network built in the
    window, over the co-occurrence kernel's device time there, %."""
    trace, work, shape = obs.get("trace"), obs.get("network_work"), \
        obs.get("shape")
    if trace is None or not work or not shape or not obs.get("networks"):
        return None
    kernel = _kernel_s(trace, COOCCUR_KERNELS)
    if kernel <= 0:
        return None
    least, _ = roofline.least_s(
        rows=work["rows"], nonzero_words=work["nonzero_words"],
        words=work["words"], mask_words=0, n_docs=shape["n_docs"],
        vocab=shape["vocab"], k=shape["k"], rates=roofline.peaks())
    return 100.0 * least * obs["networks"] / kernel
