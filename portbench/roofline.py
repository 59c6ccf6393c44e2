"""The least time the chip needs for the co-occurrence engine's counts.

Computed from the work the inputs need, whatever implements it: never
from a kernel's arguments, grid or tiling.  A row is one filter (a doc
set as a packed bitmap row of ``n_words`` 32-doc words) counted against
all ``vocab`` terms.  The operations can be done two ways, and the least
time takes the better one:

* AND + popcount of each nonzero word of each row against the term's
  packed word (``nonzero_words * vocab`` operations at the popcount rate);
* an int8 product of the rows' 0/1 incidence over ``n_docs`` documents
  by the (n_docs, vocab) incidence (``2 * rows * n_docs * vocab``
  operations at the int8 tensor-core rate).

The bytes are each selected packed word row read once (``words * vocab *
4``), the rows' masks in (``mask_words * 4``: a BFS level's (rows,
n_words) mask block; none for the whole network, whose masks are the
packed rows themselves) and each row's top-k out (``rows * k * 8``:
weights and ids).  The least time is the larger of
the operations time and the bytes time.  Rates are in ``peaks.json``.

Not covered: a sparse pair-count formulation (counting through a forward
index, which needs fewer operations on tail rows), and a b1 tensor-core
rate, which the H100 data sheet does not publish.  A program that moves
to either can beat this count: the benchmark's count must change first.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Tuple

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def peaks(path: Path = PEAKS_FILE) -> Dict[str, float]:
    """The rates of ``peaks.json`` by name."""
    raw = json.loads(Path(path).read_text())
    return {k: float(v["value"]) for k, v in raw.items()
            if isinstance(v, Mapping)}


def least_s(*, rows: int, nonzero_words: int, words: int, mask_words: int,
            n_docs: int, vocab: int, k: int,
            rates: Mapping[str, float]) -> Tuple[float, str]:
    """(seconds, what bounds it: "popcount", "int8" or "bytes") for one
    launch's worth of rows."""
    t_popc = nonzero_words * vocab / rates["popcount_ops_per_s"]
    t_int8 = 2.0 * rows * n_docs * vocab / rates["int8_ops_per_s"]
    n_bytes = 4.0 * words * vocab + 4.0 * mask_words + 8.0 * rows * k
    t_bytes = n_bytes / rates["hbm_bytes_per_s"]
    t_ops, op = (t_popc, "popcount") if t_popc <= t_int8 else (t_int8,
                                                                "int8")
    return (t_ops, op) if t_ops >= t_bytes else (t_bytes, "bytes")
