"""``kept_docs_share.network``: the documents the whole network's row
groups count over, read from the program's spans, against the same share
computed from the cell's documents."""
from __future__ import annotations

import json
import time

import pytest
import torch

from conftest import ROOT, SEED
from portbench import harness, program_spans
from portbench.systems.cooc import corpus_docs
from portbench.trace import WINDOW, Trace
from repro_torch import tracing
from repro_torch.core.materialize import GROUP

NAME = "kept_docs_share.network"


@pytest.fixture(autouse=True)
def _empty_ring():
    tracing.clear()
    yield
    tracing.clear()


def _read(obs):
    return harness.reader(ROOT / "portbench", NAME)(obs)


def _union_share(docs: torch.Tensor, vocab: int, step: int) -> float:
    """100 * sum_g |U_g| / (groups * n_docs), U_g the documents holding a
    term of row group g (terms [g * step, (g + 1) * step))."""
    n = docs.shape[0]
    groups = -(-vocab // step)
    held = torch.zeros((n, groups), dtype=torch.bool)
    d = docs.to(torch.int64)
    ok = d >= 0
    rows = torch.arange(n)[:, None].expand_as(d)
    held[rows[ok], d[ok] // step] = True
    return 100.0 * held.sum().item() / (groups * n)


def test_traced_network_reads_the_groups_documents(tiny):
    """Eight row groups over a Zipf corpus: the head group holds nearly
    every document, the tail groups a few."""
    root, base = tiny
    p = base / "configs" / "cooccur-csl.json"
    cfg = json.loads(p.read_text())
    cfg["vocab_size"] = 4096
    p.write_text(json.dumps(cfg))
    line = harness.run("csl-network", seed=SEED, seconds=1.0, trace=True,
                       t_start=time.monotonic(), root=root, base=base,
                       device="cpu")
    assert line["correct"] is True
    got = line["metrics"][NAME]
    assert got["unit"] == "%"
    docs = corpus_docs(cfg, SEED, "cpu")
    want = _union_share(docs, 4096, GROUP * 128)
    assert got["value"] == pytest.approx(want, rel=1e-12)
    assert 0 < want < 100


def test_untraced_or_without_docs_reads_nothing(monkeypatch):
    trace = Trace([("k", 0, 100)], [(WINDOW, 0, 1000)])
    shape = {"n_docs": 10}
    monkeypatch.setattr(program_spans, "_ring", lambda: (
        [("cooc.materialize.masks", 10, 20, 1, {"docs": 4}),
         ("cooc.materialize.masks", 30, 40, 1, {"docs": 6}),
         ("cooc.materialize.masks", 2000, 2100, 1, {"docs": 1}),
         ("cooc.materialize.count", 40, 50, 1, {"docs": 1})], 0))
    assert _read({"trace": trace, "shape": shape}) == pytest.approx(50.0)
    assert _read({"trace": None, "shape": shape}) is None
    monkeypatch.setattr(program_spans, "_ring", lambda: (
        [("cooc.materialize.masks", 10, 20, 1, {"r0": 0})], 0))
    assert _read({"trace": trace, "shape": shape}) is None
    monkeypatch.setattr(program_spans, "_ring", lambda: (
        [("cooc.materialize.masks", 10, 20, 1, {"docs": 4})], 1))
    assert _read({"trace": trace, "shape": shape}) is None
    monkeypatch.setattr(program_spans, "_ring", lambda: None)
    assert _read({"trace": trace, "shape": shape}) is None
