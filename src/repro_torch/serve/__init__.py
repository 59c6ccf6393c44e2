"""Serving: the plan-aware micro-batching engine (``cooc_engine``), the
asyncio multi-tenant front end over it (``server``: admission control,
deadline-aware micro-batching, tenancy, metrics, warm start from a
snapshot), and the language model's continuous-batching decode server
(``engine``: ``DecodeServer`` and ``Request``).  Mirrors
``repro.serve``."""
from repro_torch.serve.admission import (  # noqa: F401
    AdmissionController,
    AdmissionDecision,
    AdmissionPolicy,
    StepTimeModel,
    estimate_wait_ms,
)
from repro_torch.serve.cooc_engine import (  # noqa: F401
    CoocEngine,
    CoocFuture,
    CoocRequest,
    EngineClosedError,
    EngineStats,
)
from repro_torch.serve.engine import DecodeServer, Request  # noqa: F401
from repro_torch.serve.metrics import (  # noqa: F401
    LatencyHistogram,
    MetricsSnapshot,
    QuantileSummary,
    ServerMetrics,
    TenantCounters,
    percentile_ms,
)
from repro_torch.serve.server import (  # noqa: F401
    CoocServer,
    ServeResponse,
    ServerConfig,
    TenantConfig,
)
