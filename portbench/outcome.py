"""What a system module hands back to the harness after one run."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Check:
    """One number compared, beside its limit: correct needs ``value <=
    limit`` (``at_least=False``) or ``value >= limit``."""
    name: str
    value: float
    limit: float
    at_least: bool = False

    @property
    def ok(self) -> bool:
        return self.value >= self.limit if self.at_least \
            else self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]          # every end-to-end metric the run took
    obs: Dict[str, Any]            # what the per-layer readers read
    attempted: int
    failed: int
    checks: List[Check]
    peak_bytes: int
    trace: Optional[Any] = None    # portbench.trace.Trace of a traced run
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)
