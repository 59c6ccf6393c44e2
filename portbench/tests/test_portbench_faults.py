"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have; and the control (the reference in
float16 in the program's place) fails the check.  The harness's look for
a card is skipped (``device="cpu"``); the rest of the run is driven."""
from __future__ import annotations

import time

import numpy as np
import pytest

from conftest import SEED, copies_of_one_network
from portbench import control, harness


def _run(tiny, cell, seconds=1.5):
    root, base = tiny
    return harness.run(cell, seed=SEED, seconds=seconds, trace=False,
                       t_start=time.monotonic(), root=root, base=base,
                       device="cpu")


def test_sound_runs_are_correct(tiny):
    for cell in ("csl-search", "csl-window-ingest", "csl-network",
                 "csl-batch"):
        line = _run(tiny, cell, 1.0)
        assert line["correct"] is True, (cell, line["checks"])


def test_answer_altered_where_produced_search(tiny, monkeypatch):
    from repro_torch.serve.cooc_engine import CoocEngine
    orig = CoocEngine.step

    def step(self):
        n = orig(self)
        for r in list(self.finished)[-n:] if n else []:
            w = r.result.network.weight
            ok = np.flatnonzero(np.asarray(r.result.network.valid))
            if len(ok):
                w[ok[-1]] += 1
        return n

    monkeypatch.setattr(CoocEngine, "step", step)
    line = _run(tiny, "csl-search")
    assert line["correct"] is False
    assert line["checks"]["answers_wrong"]["value"] > 0


def test_answer_altered_where_produced_network(tiny, monkeypatch):
    import repro_torch.core as core
    orig = core.materialize

    def materialize(*a, **kw):
        net = orig(*a, **kw)
        return net._replace(weight=net.weight + net.valid.to(net.weight.dtype))

    monkeypatch.setattr(core, "materialize", materialize)
    line = _run(tiny, "csl-network", 0.5)
    assert line["correct"] is False
    assert line["checks"]["rows_wrong"]["value"] > 0


def test_answer_altered_in_a_later_network(tiny, monkeypatch):
    """Only the window's second network is altered: the check reads the
    sampled rows of every network built, not of the first alone."""
    import repro_torch.core as core

    def second(i, net):
        if i != 2:
            return net
        return net._replace(weight=net.weight + net.valid.to(net.weight.dtype))

    monkeypatch.setattr(core, "materialize",
                        copies_of_one_network(core.materialize, second))
    line = _run(tiny, "csl-network", 0.3)
    assert line["attempted"] >= 2
    assert line["correct"] is False
    wrong = line["checks"]["rows_wrong"]["value"]
    per_net = line["checks"]["rows_checked"]["value"] // line["attempted"]
    assert 0 < wrong <= per_net


def test_half_of_the_batch_left_out(tiny, monkeypatch):
    import repro_torch.serve.cooc_engine as eng
    orig = eng.bfs_construct_batch

    def half(index, seeds, **kw):
        seeds = seeds.clone()
        seeds[seeds.shape[0] // 2:] = -1
        return orig(index, seeds, **kw)

    monkeypatch.setattr(eng, "bfs_construct_batch", half)
    line = _run(tiny, "csl-batch")
    assert line["correct"] is False
    assert line["checks"]["answers_wrong"]["value"] > 0


def test_ingest_that_leaves_the_state_unchanged(tiny, monkeypatch):
    from repro_torch.serve import CoocServer

    async def ingest(self, tenant, doc_terms, **kwargs):
        return []

    monkeypatch.setattr(CoocServer, "ingest", ingest)
    line = _run(tiny, "csl-window-ingest")
    assert line["correct"] is False
    assert line["checks"]["epochs_off"]["value"] > 0
    assert line["checks"]["cold_blocks_missing"]["value"] > 0


def test_block_committed_after_the_ingest_returns(tiny, monkeypatch):
    """An evicted block written to the cold store only after its ingest
    has returned: every block is there and right by the time the window's
    checks read them, so only the check at each ingest's return sees it."""
    import threading
    from repro_torch.core import FileStorage
    orig = FileStorage.__setitem__
    late = []

    def deferred(self, key, value):
        t = threading.Timer(0.05, orig, (self, key, value))
        late.append(t)
        t.start()

    monkeypatch.setattr(FileStorage, "__setitem__", deferred)
    line = _run(tiny, "csl-window-ingest")
    for t in late:
        t.join()
    assert late
    assert line["correct"] is False
    assert line["checks"]["blocks_uncommitted_at_return"]["value"] > 0
    assert line["checks"]["cold_blocks_missing"]["value"] == 0
    assert line["checks"]["cold_blocks_wrong"]["value"] == 0


def _control_size(base):
    """Counts past 2,048, where float16 stops holding every integer: the
    head seeds are the four most frequent terms."""
    import json
    for name in ("cooccur-csl", "cooccur-csl-window"):
        p = base / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c["n_docs"] = 16000
        if c["window"]:
            c["window"]["docs"] = 16000
        p.write_text(json.dumps(c))
    for name in ("head-tail-d3", "head-tail-d2-ingest"):
        p = base / "traffic" / f"{name}.json"
        c = json.loads(p.read_text())
        c.update(head_terms=4, tail_df=[1, 64])
        p.write_text(json.dumps(c))


@pytest.mark.parametrize("cell,key", [("csl-search", "answers_wrong"),
                                      ("csl-window-ingest", "answers_wrong"),
                                      ("csl-network", "rows_wrong"),
                                      ("csl-batch", "answers_wrong")])
def test_control_fails_the_check(tiny, cell, key):
    """The reference in float16 in the program's place, run through the
    harness, comes out not correct on every seed tried; the reference at
    the program's own precision in the same place comes out correct."""
    root, base = tiny
    _control_size(base)
    for seed in (SEED, SEED + 1, SEED + 2):
        low = control.control(cell, seed, "float16", "cpu", root=root,
                              base=base, seconds=1.0)
        assert low["correct"] is False, (cell, seed, low["checks"])
        assert low["checks"][key]["value"] > 0
    exact = control.control(cell, SEED, "int32", "cpu", root=root,
                            base=base, seconds=1.0)
    assert exact["correct"] is True, exact["checks"]
