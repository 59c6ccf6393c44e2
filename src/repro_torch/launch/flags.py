"""Runtime flags (env-var driven, read once per call site): a copy of
``repro.launch.flags``.

REPRO_UNROLL_SCANS=1 — the reference replaces every ``lax.scan`` of a
small static trip count with a Python loop so that XLA's cost analysis
counts each iteration.  The port has no scans (its loops are Python
loops, and its counter sees every iteration), so the mode changes only
what the reference's cells change with it: ``microbatches=1`` in the LM
train cell.
"""
from __future__ import annotations

import os


def unroll_scans() -> bool:
    return os.environ.get("REPRO_UNROLL_SCANS", "0") == "1"
