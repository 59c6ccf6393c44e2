"""Serving quantiles, copied from ``repro.serve.metrics``: the one quantile
implementation of the port's serving stack."""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

#: the serving stack's canonical quantile set (fractions of 100)
SERVING_QUANTILES: Tuple[float, ...] = (50.0, 95.0, 99.0, 99.9)


def percentile_ms(samples: Sequence[float],
                  qs: Iterable[float] = SERVING_QUANTILES) -> Tuple[float, ...]:
    """``np.percentile`` (linear interpolation) over a sample snapshot;
    0.0 for every requested quantile when ``samples`` is empty."""
    qs = tuple(qs)
    xs = np.asarray(samples, dtype=np.float64)
    if xs.size == 0:
        return tuple(0.0 for _ in qs)
    return tuple(float(v) for v in np.percentile(xs, qs))
