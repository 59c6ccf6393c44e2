"""The MEDLINE/MeSH shard's cell (``medline-network``) through the harness
on the CPU, at a shrunk copy of its configuration whose head row groups
span several document chunks; its four per-layer readers; and the control
of its correctness check."""
from __future__ import annotations

import importlib
import json
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, SEED
from portbench import control, harness, program_spans, reference
from portbench.systems.cooc import corpus_docs
from portbench.trace import WINDOW, Trace
from repro_torch import tracing

CELL = "medline-network"
NEW = ["network_roofline.medline", "launches_per_network.medline",
       "chunk_idle_ms.medline", "idle_share.medline", "topk_ms.medline"]
#: the shrunk configuration: a vocabulary that is not a multiple of 128,
#: so the last row group is short and the column tiles ragged
DOCS, VOCAB = 16000, 1000
#: documents a launch at the shrunk size: the head group spans four
CHUNK = 4096


@pytest.fixture(autouse=True)
def _empty_ring():
    tracing.clear()
    yield
    tracing.clear()


def _shrunk(tiny, monkeypatch, n_docs, vocab, chunk):
    """(root, base, cfg) with the MEDLINE configuration cut to ``n_docs``
    over ``vocab`` terms and the sweep's document chunk to ``chunk``."""
    mat = importlib.import_module("repro_torch.core.materialize")
    root, base = tiny
    p = base / "configs" / "cooccur-medline-mesh.json"
    cfg = json.loads(p.read_text())
    cfg.update(n_docs=n_docs, vocab_size=vocab)
    p.write_text(json.dumps(cfg))
    monkeypatch.setattr(mat, "DOC_CHUNK", chunk)
    return root, base, cfg


@pytest.fixture
def medline(tiny, monkeypatch):
    """The configuration cut to the CPU; every co-occurrence call is
    counted in ``ops.LAUNCHES`` as a launch on the card is."""
    from repro_torch.kernels import ops
    out = _shrunk(tiny, monkeypatch, DOCS, VOCAB, CHUNK)
    real = ops.cooccur_counts

    def counted(x_l, x_r):
        assert x_l.shape[0] <= CHUNK
        ops._count("cooccur_counts")
        return real(x_l, x_r)

    monkeypatch.setattr(ops, "cooccur_counts", counted)
    return out


def _run(medline, trace, seed=SEED, seconds=1.0):
    root, base, _ = medline
    return harness.run(CELL, seed=seed, seconds=seconds, trace=trace,
                       t_start=time.monotonic(), root=root, base=base,
                       device="cpu")


def _chunks_a_network(cfg, seed, step=512):
    """Launches a network: each row group's union of documents in chunks
    of ``CHUNK``, counted from the cell's documents."""
    docs = corpus_docs(cfg, seed, "cpu").to(torch.int64)
    n_groups = -(-(-(-VOCAB // 128) * 128) // step)
    held = torch.zeros((docs.shape[0], n_groups), dtype=torch.bool)
    ok = docs >= 0
    rows = torch.arange(docs.shape[0])[:, None].expand_as(docs)
    held[rows[ok], docs[ok] // step] = True
    unions = held.sum(0).numpy()
    assert unions[0] > 3 * CHUNK
    return int(sum(-(-u // CHUNK) for u in unions))


def test_the_cell_is_named_once():
    spec = harness.load_spec(ROOT)
    cell = harness.workload(spec, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("cooccur-medline-mesh", "analyst-network", 1)
    assert [m["name"] for m in harness.end_to_end(spec, CELL)] == \
        ["network_s", "device_peak_gb", "setup_s"]
    layer = {m["name"]: m for m in harness.per_layer(spec, CELL)}
    assert set(layer) == set(NEW)
    for m in layer.values():
        assert (m["moves"], m["workloads"]) == ("network_s", [CELL])
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "cooccur-medline-mesh.json").read_text())
    assert (cfg["n_docs"], cfg["vocab_size"], cfg["window"]) == \
        (7_750_000, 30_454, None)
    assert cfg["reference"] == "portbench/reference.py"


def test_untraced_run_is_correct_and_reads_no_layer(medline):
    line = _run(medline, trace=False)
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["rows_wrong"]["value"] == 0
    assert set(line["metrics"]) == {"network_s", "device_peak_gb",
                                    "setup_s"}
    assert tracing.spans() == []


def test_traced_run_reads_the_chunks(medline):
    """Traced on the CPU: correct; one launch a chunk of each group's
    documents; one chunk span a launch, one masks span a group.  The
    device readers have no device operation to read here (their
    arithmetic: the test below; on the card, the last test)."""
    line = _run(medline, trace=True)
    assert line["correct"] is True, line["checks"]
    want = _chunks_a_network(medline[2], SEED)
    assert line["metrics"]["launches_per_network.medline"] == {
        "value": float(want), "unit": "launches"}
    for name in NEW:
        if name != "launches_per_network.medline":
            assert name not in line["metrics"]
    names = [s[0] for s in tracing.spans()]
    assert names.count("cooc.materialize.chunk") == \
        want * names.count("cooc.materialize.topk") // 2


def test_the_readers_on_a_synthetic_trace(monkeypatch):
    """A window of 1,000 ns, busy [0, 100) (kernel 3) and [200, 300):
    idle [100, 200) inside a chunk span and [300, 1000) outside; two
    networks, ten launches."""
    trace = Trace([("void cooccur_wgmma<128>(int)", 0, 100),
                   ("topk", 200, 300)], [(WINDOW, 0, 1000)])
    monkeypatch.setattr(program_spans, "_ring", lambda: (
        [("cooc.materialize.chunk", 90, 250, 1,
          {"r0": 0, "c0": 0, "docs": 5})], 0))
    work = {"rows": 1000, "nonzero_words": 10 ** 6, "words": 10 ** 4}
    shape = {"n_docs": 10 ** 5, "vocab": 1000, "k": 16}
    obs = {"trace": trace, "networks": 2, "launches": {"cooccur_counts": 10},
           "network_work": work, "shape": shape}
    read = {n: harness.reader(ROOT / "portbench", n)(obs) for n in NEW}
    assert read["launches_per_network.medline"] == 5.0
    assert read["chunk_idle_ms.medline"] == pytest.approx(100 / 2e6)
    assert read["idle_share.medline"] == pytest.approx(80.0)
    assert read["network_roofline.medline"] > 0
    # a trace that ties no device operation to its launch
    assert read["topk_ms.medline"] is None
    # a program without chunk spans: the chunk reader reads nothing
    monkeypatch.setattr(program_spans, "_ring", lambda: (
        [("cooc.materialize.masks", 90, 250, 1, {"docs": 5})], 0))
    assert harness.reader(ROOT / "portbench",
                          "chunk_idle_ms.medline")(obs) is None


def test_the_control_fails_on_the_cell(medline):
    """The reference in float16 in the program's place comes out not
    correct on every seed tried; at the program's own precision, correct."""
    root, base, _ = medline
    for seed in (SEED, SEED + 1, SEED + 2):
        low = control.control(CELL, seed, "float16", "cpu", root=root,
                              base=base, seconds=1.0)
        assert low["correct"] is False, (seed, low["checks"])
        assert low["checks"]["rows_wrong"]["value"] > 0
    exact = control.control(CELL, SEED, "int32", "cpu", root=root,
                            base=base, seconds=1.0)
    assert exact["correct"] is True, exact["checks"]


def test_the_reference_holds_the_configuration_shrunk(medline):
    """The configuration's reference is ``portbench/reference.py``: at the
    shrunk size its rows of the network are the exact counts, checked
    here against a dense count of the same documents."""
    _, _, cfg = medline
    docs = corpus_docs(dict(cfg, n_docs=3000), SEED, "cpu")
    index = reference.Index(docs, VOCAB)
    x = torch.zeros((3000, VOCAB), dtype=torch.float64)
    d = docs.to(torch.int64)
    ok = d >= 0
    x[torch.arange(3000)[:, None].expand_as(d)[ok], d[ok]] = 1
    full = (x.t() @ x).to(torch.int64)
    terms = [0, 1, 7, VOCAB - 1]
    dst, wt = reference.network_rows(index, terms, 16)
    for r, t in enumerate(terms):
        row = full[t].clone()
        row[t] = -1
        order = torch.sort(-row, stable=True).indices[:16]
        w = row[order].numpy()
        np.testing.assert_array_equal(wt[r], np.where(w > 0, w, 0))
        np.testing.assert_array_equal(
            dst[r], np.where(w > 0, order.numpy(), -1))


@pytest.mark.gpu
def test_the_cell_on_the_card_at_a_mid_size(tiny, monkeypatch):
    """On the card, 200,000 documents over MeSH's 30,454 terms in chunks
    of 65,536: traced, correct, and every new reader reads, the kernel's
    share of its roofline count under 100%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    root, base, _ = _shrunk(tiny, monkeypatch, 200_000, 30_454, 1 << 16)
    line = harness.run(CELL, seed=SEED, seconds=1.0, trace=True,
                       t_start=time.monotonic(), root=root, base=base,
                       device="cuda:0")
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == set(NEW)
    assert 0 < line["metrics"]["network_roofline.medline"]["value"] < 100
    assert line["metrics"]["launches_per_network.medline"]["value"] > 60
