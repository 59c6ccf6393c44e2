"""Serving: the plan-aware micro-batching engine (``cooc_engine``)."""
from repro_torch.serve.cooc_engine import (  # noqa: F401
    CoocEngine,
    CoocFuture,
    EngineClosedError,
    EngineStats,
)
from repro_torch.serve.metrics import percentile_ms  # noqa: F401
