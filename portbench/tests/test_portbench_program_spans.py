"""The program's own spans as the benchmark reads them: the arithmetic of
``program_spans`` on a synthetic trace, and tiny CPU runs of every cell
through the harness with the program's recorder behind them."""
from __future__ import annotations

import json
import time

import pytest

from conftest import ROOT, SEED
from portbench import harness, program_spans
from portbench.trace import WINDOW, Trace
from repro_torch import tracing

#: the new readers, by cell: host readings, then device idle (None on the
#: CPU, which records no device operation)
HOST = {"csl-batch": ["submit_ms.batch", "step_prepare_ms.batch",
                      "step_resolve_ms.batch"],
        "csl-search": ["queue_wait_p95_ms.search", "lane_step_ms.search"],
        "csl-window-ingest": ["ingest_lists_ms.window", "retire_ms.window",
                              "spill_encode_ms.window",
                              "spill_write_ms.window",
                              "ingest_scatter_ms.window"],
        "csl-network": []}
IDLE = {"csl-network": ["masks_idle_ms.network", "count_idle_ms.network",
                        "topk_idle_ms.network"]}
#: the program's spans each cell opens in its window
OPENED = {"csl-batch": {"cooc.engine.submit", "cooc.engine.prepare",
                        "cooc.engine.resolve"},
          "csl-network": {"cooc.materialize.masks", "cooc.materialize.count",
                          "cooc.materialize.topk"},
          "csl-search": {"cooc.server.queue", "cooc.server.lane_step"},
          "csl-window-ingest": {"cooc.ingest.lists", "cooc.ingest.retire",
                                "cooc.spill.encode", "cooc.spill.write",
                                "cooc.ingest.scatter"}}
#: the readers BENCHMARK.json does not name: the open cells', kept for a
#: later benchmark, and the engine's of csl-batch, whose per-layer list
#: test_portbench_harness.py holds exactly. Added to the test's copy of
#: the spec as ``conftest.LATER`` adds the open cells.
LATER = [{"name": n, "unit": "ms", "better": "lower",
          "source": "program_span", "layer": layer, "moves": moves,
          "workloads": [c]}
         for c, layer, moves in (
             ("csl-batch", "engine", "queries_per_s"),
             ("csl-search", "server", "query_p95_ms"),
             ("csl-window-ingest", "streaming tier", "query_p95_ms"))
         for n in HOST[c]]


@pytest.fixture(autouse=True)
def _empty_ring():
    tracing.clear()
    yield
    tracing.clear()


def _trace(busy, lo=0, hi=1000):
    return Trace([("k", a, b) for a, b in busy], [(WINDOW, lo, hi)])


def _ring(monkeypatch, spans, dropped=0):
    monkeypatch.setattr(program_spans, "_ring", lambda: (
        [(n, a, b, 1, {}) for n, a, b in spans], dropped))


def test_idle_goes_to_the_innermost_span():
    # idle stretches: [100, 200) mid 150, [300, 600) mid 450, [700, 1000)
    trace = _trace([(0, 100), (200, 300), (600, 700)])
    spans = [("outer", 50, 500), ("inner", 120, 180), ("late", 400, 440)]
    got = program_spans.idle_by_span(trace, spans)
    assert got == {"inner": 100 / 1e9, "outer": 300 / 1e9,
                   None: 300 / 1e9}
    # the shortest of the spans around a middle, whichever opened first
    got = program_spans.idle_by_span(trace, [("wide", 0, 1000),
                                             ("mid", 300, 650),
                                             ("end", 640, 1000)])
    assert got == {"wide": 100 / 1e9, "mid": 300 / 1e9, "end": 300 / 1e9}
    assert program_spans.idle_by_span(trace, []) == {None: 700 / 1e9}


def test_idle_readers_per_network(monkeypatch):
    trace = _trace([(0, 100), (200, 300), (600, 700)])
    _ring(monkeypatch, [("cooc.materialize.masks", 120, 180),
                        ("cooc.materialize.count", 50, 500),
                        ("cooc.materialize.topk", 800, 900)])
    obs = {"trace": trace, "networks": 2}
    read = {n: harness.reader(ROOT / "portbench", n)(obs)
            for n in IDLE["csl-network"]}
    assert read == pytest.approx({"masks_idle_ms.network": 100 / 2e6,
                                  "count_idle_ms.network": 300 / 2e6,
                                  "topk_idle_ms.network": 300 / 2e6})
    # a window without device operations has no idle to attribute
    assert program_spans.idle_ms_per_network(
        {"trace": _trace([]), "networks": 2}, "cooc.materialize.masks") \
        is None


@pytest.mark.parametrize("name", ["topk_ms.network", "topk_ms.medline"])
def test_device_time_goes_to_the_span_that_launched_it(monkeypatch, name):
    """A top-k span [100, 200): an operation launched inside it and run
    after it counts; one run inside it but launched before it does not,
    nor one launched after it.  A launch at the span's start counts, one
    at its end does not."""
    ops = [("early", 120, 180, 1),       # launched at 50
           ("late", 300, 400, 2),        # launched at 150
           ("later", 400, 450, 3),       # launched at 100
           ("after", 500, 600, 4),       # launched at 200
           ("nothing", 700, 710, 0)]     # no launch recorded
    launches = [(1, 50), (2, 150), (3, 100), (4, 200), (5, 160)]
    trace = Trace(ops, [(WINDOW, 0, 1000)], launches)
    _ring(monkeypatch, [("cooc.materialize.topk", 100, 200),
                        ("cooc.materialize.count", 40, 60)])
    obs = {"trace": trace, "networks": 2}
    read = harness.reader(ROOT / "portbench", name)
    assert read(obs) == pytest.approx((100 + 50) / 2e6)
    assert trace.launched_s([(40, 60)]) == pytest.approx(60 / 1e9)
    # no launch tied to a device operation, a ring that overflowed, or
    # no top-k span in the window: nothing to read
    bare = Trace([o[:3] for o in ops], [(WINDOW, 0, 1000)], launches)
    assert read({"trace": bare, "networks": 2}) is None
    _ring(monkeypatch, [("cooc.materialize.topk", 100, 200)], dropped=1)
    assert read(obs) is None
    _ring(monkeypatch, [("cooc.materialize.count", 100, 200)])
    assert read(obs) is None


def test_spans_are_clipped_to_the_window(monkeypatch):
    trace = _trace([(0, 1000)], lo=1000, hi=2000)
    _ring(monkeypatch, [("cooc.engine.prepare", 900, 1100),
                        ("cooc.engine.prepare", 1200, 1500),
                        ("cooc.engine.prepare", 1900, 2400),
                        ("cooc.engine.prepare", 2100, 2200),
                        ("cooc.engine.submit", 500, 990)])
    obs = {"trace": trace}
    assert program_spans.window_spans(obs) == [
        ("cooc.engine.prepare", 1000, 1100),
        ("cooc.engine.prepare", 1200, 1500),
        ("cooc.engine.prepare", 1900, 2000)]
    assert program_spans.mean_ms(obs, "cooc.engine.prepare") == \
        pytest.approx(500 / 3 / 1e6)
    # nothing of the name inside the window: nothing to read
    assert program_spans.mean_ms(obs, "cooc.engine.submit") is None
    assert program_spans.per_step_ms(obs, "cooc.engine.submit") is None


def test_p95_and_per_step(monkeypatch):
    trace = _trace([], lo=0, hi=10 ** 9)
    waits = [("cooc.server.queue", 0, (i + 1) * 10 ** 6) for i in range(40)]
    steps = [("cooc.engine.prepare", 0, 1), ("cooc.engine.prepare", 2, 3)]
    submits = [("cooc.engine.submit", 0, 2 * 10 ** 6)] * 3
    _ring(monkeypatch, waits + steps + submits)
    obs = {"trace": trace}
    assert program_spans.p95_ms(obs, "cooc.server.queue") == 38.0
    assert program_spans.per_step_ms(obs, "cooc.engine.submit") == 3.0


def test_lost_spans_read_nothing(monkeypatch):
    """A ring that overflowed, or a program that keeps no spans: every
    reader returns None."""
    trace = _trace([(0, 100)])
    spans = [(s, 10, 20) for c in OPENED.values() for s in c]
    obs = {"trace": trace, "networks": 1}
    names = [n for c in (HOST, IDLE) for v in c.values() for n in v]
    _ring(monkeypatch, spans)
    assert all(harness.reader(ROOT / "portbench", n)(obs) is not None
               for n in names)
    _ring(monkeypatch, spans, dropped=1)
    assert [harness.reader(ROOT / "portbench", n)(obs) for n in names] == \
        [None] * len(names)
    monkeypatch.setattr(program_spans, "_ring", lambda: None)
    assert [harness.reader(ROOT / "portbench", n)(obs) for n in names] == \
        [None] * len(names)
    assert program_spans.window_spans({"trace": None}) is None


def _later(root):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"] += LATER
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.mark.parametrize("cell", sorted(OPENED))
def test_traced_cells_read_the_program_spans(tiny, cell):
    root, base = tiny
    _later(root)
    line = harness.run(cell, seed=SEED, seconds=1.2, trace=True,
                       t_start=time.monotonic(), root=root, base=base,
                       device="cpu")
    assert line["correct"] is True
    for name in HOST[cell]:
        assert line["metrics"][name]["value"] > 0, name
        assert line["metrics"][name]["unit"] == "ms"
    for name in IDLE.get(cell, []):
        assert name not in line["metrics"]
    opened = {s[0] for s in tracing.spans()}
    assert OPENED[cell] <= opened
    assert tracing.dropped() == 0


def test_an_untraced_run_reads_and_keeps_nothing(tiny):
    root, base = tiny
    line = harness.run("csl-batch", seed=SEED, seconds=0.5, trace=False,
                       t_start=time.monotonic(), root=root, base=base,
                       device="cpu")
    assert set(line["metrics"]) == {"queries_per_s", "device_peak_gb",
                                    "setup_s"}
    assert tracing.spans() == []


def test_the_benchmark_names_each_new_reader_once():
    spec = harness.load_spec(ROOT)
    named = {m["name"]: m for m in spec["per_layer"]}
    for n in IDLE["csl-network"]:
        m = named[n]
        assert (m["unit"], m["better"], m["source"], m["workloads"]) \
            == ("ms", "lower", "program_span", ["csl-network"])
    for m in LATER:
        assert m["name"] not in named
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
