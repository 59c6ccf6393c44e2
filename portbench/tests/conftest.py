"""Shared pieces of the benchmark's CPU tests: the program on the path,
and a copy of the benchmark's data at a size the CPU holds.

Run from the root of the repository: ``python -m pytest portbench/tests``.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: a seed past 32 bits, as a checking run's may be
SEED = 2 ** 31 + 11

#: the open-loop cells whose data files portbench/ keeps for a later
#: benchmark (PERF.md, Open questions): not in BENCHMARK.json, so the tests
#: that drive them add them to their copy of it
LATER = {
    "configs": [{"name": "cooccur-csl-window",
                 "source": "https://arxiv.org/abs/2308.08756",
                 "file": "portbench/configs/cooccur-csl-window.json",
                 "reduced": [], "why": "the CSL corpus as a sliding window"}],
    "workloads": [{"name": "csl-search", "config": "cooccur-csl",
                   "traffic": "head-tail-d3", "chips": 1,
                   "why": "open-loop one-seed depth-3 queries"},
                  {"name": "csl-window-ingest",
                   "config": "cooccur-csl-window",
                   "traffic": "head-tail-d2-ingest", "chips": 1,
                   "why": "blocks ingested under open-loop queries"}],
    "end_to_end": [{"name": "query_p95_ms", "unit": "ms", "better": "lower",
                    "bound": 0.25, "source": "host_clock",
                    "workloads": ["csl-search", "csl-window-ingest"]}],
    "per_layer": [{"name": n, "unit": u, "better": b, "source": s,
                   "layer": layer, "moves": "query_p95_ms",
                   "workloads": [c]}
                  for n, u, b, s, layer, c in (
        ("shed_share.search", "%", "lower", "program_counter", "server",
         "csl-search"),
        ("batch_occupancy.search", "queries", "higher", "program_counter",
         "engine", "csl-search"),
        ("launches_per_batch.search", "launches", "lower",
         "program_counter", "bfs and count methods", "csl-search"),
        ("bfs_roofline.search", "%", "higher", "device_trace", "kernels",
         "csl-search"),
        ("idle_share.search", "%", "lower", "device_trace", "device",
         "csl-search"),
        ("ingest_host_ms.window", "ms", "lower", "program_span",
         "streaming tier", "csl-window-ingest"),
        ("idle_share.window", "%", "lower", "device_trace", "device",
         "csl-window-ingest"))],
}


def shrink(base: Path) -> None:
    """Cut the benchmark's data in ``base`` to a CPU-sized copy: a few
    thousand documents over 512 terms, the plain count method, low rates."""
    for name in ("cooccur-csl", "cooccur-csl-window"):
        p = base / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c["n_docs"], c["vocab_size"] = 3000, 512
        if c["window"]:
            c["window"].update(docs=3000, block=256)
        # the fused level step's plain version is slow on the CPU
        c["server"]["method"] = "gemm"
        p.write_text(json.dumps(c))
    for name in ("head-tail-d3", "head-tail-d2-ingest"):
        p = base / "traffic" / f"{name}.json"
        c = json.loads(p.read_text())
        c.update(rate_per_s=40.0, head_terms=32, tail_df=[1, 8])
        if "ingest" in c:
            c["ingest"].update(docs=256, every_s=0.5)
        p.write_text(json.dumps(c))
    p = base / "traffic" / "zipf-d2-batch256.json"
    c = json.loads(p.read_text())
    c.update(queries=16, method="gemm")
    p.write_text(json.dumps(c))
    for p in (base / "cells").glob("*.json"):
        c = json.loads(p.read_text())
        c["check"]["sample"] = min(c["check"]["sample"], 24)
        p.write_text(json.dumps(c))


@pytest.fixture
def tiny(tmp_path):
    """(root, base): a BENCHMARK.json with the ``LATER`` cells added, and a
    CPU-sized copy of the benchmark's data files."""
    base = tmp_path / "portbench"
    for d in ("configs", "cells", "traffic", "metrics"):
        shutil.copytree(ROOT / "portbench" / d, base / d)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in LATER.items():
        spec[key] = spec[key] + entries
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    shrink(base)
    return tmp_path, base


def copies_of_one_network(orig, alter=None):
    """A ``materialize`` that builds the set-up's network and hands out
    copies of it after that, so that a window on a loaded CPU holds many;
    ``alter(i, net)`` may change the i-th network handed out (0: the
    set-up's)."""
    built, calls = [], 0

    def materialize(*a, **kw):
        nonlocal calls
        if not built:
            built.append(orig(*a, **kw))
        net = built[0]._replace(**{f: t.clone() for f, t
                                   in built[0]._asdict().items()})
        calls += 1
        return alter(calls - 1, net) if alter else net

    return materialize
