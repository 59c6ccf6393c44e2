"""The port's ``CoocIndex`` facade against ``repro.api.CoocIndex``, and the
port's isolation rules.

The quickstart corpus goes through both facades (the port on
``device="cpu"``); term-string networks and top lists must be identical,
before and after an ingest that grows the vocabulary, for every count
method and for tag and duration scopes.  The isolation tests check that the
port imports neither jax nor the reference package, and that its entry
points refuse to fall back to the CPU when no card is present.
"""
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.api import CoocIndex as JIndex  # noqa: E402
from repro_torch.api import CoocIndex  # noqa: E402
from repro_torch.core import CapacityError, QueryContext, pack_docs  # noqa: E402
from repro_torch.serve import CoocEngine  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"

QUICKSTART = [
    "graph neural networks learn node embeddings from graph structure",
    "co-occurrence networks reveal semantic relationships in text corpora",
    "inverted index maps keywords to documents for fast retrieval",
    "breadth first search expands the network frontier level by level",
    "keyword co-occurrence networks support text mining and retrieval",
    "the inverted index makes co-occurrence network construction fast",
    "semantic networks and knowledge graphs organise scientific keywords",
    "fast retrieval of documents uses the inverted index keywords",
    "text mining extracts keywords and builds co-occurrence networks",
    "network construction from an inverted index runs in real time",
]
FRESH = ["streaming documents extend the lexicon with unseen vocabulary",
         "unseen vocabulary grows the inverted index networks"] * 2
PLAN = dict(depth=2, topk=6, beam=8, q_batch=4, vocab_capacity=16)


@pytest.mark.parametrize("method", ["gemm", "popcount", "pallas", "fused"])
def test_quickstart_network_matches_reference(method):
    ours = CoocIndex.from_texts(QUICKSTART[:4], device="cpu", method=method,
                                **PLAN)
    ref = JIndex.from_texts(QUICKSTART[:4], method=method, **PLAN)
    assert ours.network(["index"]) == ref.network(["index"])
    assert ours.top(["index"], limit=5) == ref.top(["index"], limit=5)
    vocab = ours.ctx.vocab_size
    ours.add_documents(QUICKSTART[4:] + FRESH)
    ref.add_documents(QUICKSTART[4:] + FRESH)
    assert ours.ctx.vocab_size > vocab                # the term axis grew
    assert ours.n_terms == ref.n_terms and ours.n_docs == ref.n_docs
    for seeds in (["networks"], ["vocabulary"], ["index", "unseen"]):
        assert ours.network(seeds) == ref.network(seeds)
        assert ours.top(seeds, limit=4, depth=1) == \
            ref.top(seeds, limit=4, depth=1)


def test_source_tags_and_time_scopes_match_reference():
    kw = dict(depth=2, topk=5, beam=8, q_batch=2, method="fused")
    ours, ref = CoocIndex(device="cpu", **kw), JIndex(**kw)
    for idx in (ours, ref):
        idx.add_documents(QUICKSTART[:5], timestamp=1000.0, source="old")
        idx.add_documents(QUICKSTART[5:], timestamp=5000.0, source="new")
    for scope, now in (("old", None), ("new", None), ("1h", 5100.0),
                       ("2h", 5100.0), ("1h", 9000.0)):
        assert ours.network(["index"], scope=scope, now=now) == \
            ref.network(["index"], scope=scope, now=now)
    with pytest.raises(KeyError):
        ours.network(["index"], scope="nowhere")
    with pytest.raises(KeyError):
        ours.term_id("absent")
    with pytest.raises(ValueError, match="duration"):
        ours.add_documents(["x y"], source="7d")


def test_rejected_batch_leaves_no_trace():
    idx = CoocIndex(device="cpu", capacity=32, on_overflow="raise")
    idx.add_documents(QUICKSTART)
    n_terms = idx.n_terms
    with pytest.raises(CapacityError):
        idx.add_documents(["brand new words"] * 30)
    assert idx.n_terms == n_terms and "brand" not in idx


def test_unported_surfaces_raise():
    for kw in ({"window": 64}, {"cold_store": {}}, {"mesh": object()},
               {"devices": 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            CoocIndex(device="cpu", **kw)
    idx = CoocIndex(device="cpu")
    for call in (idx.full_network, idx.network_stats, idx.save):
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(NotImplementedError):
        CoocIndex.load("somewhere")


_ISOLATION = """
import sys
sys.modules["jax"] = None          # any import of jax now raises
import repro_torch, repro_torch.api, repro_torch.core, repro_torch.serve
import repro_torch.kernels.build, repro_torch.kernels.postings
import repro_torch.kernels.level_step, repro_torch.configs.cooccur_csl
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                and (m == "repro" or m.startswith(("repro.", "jax"))))
print(leaked)
"""


def test_port_imports_neither_jax_nor_reference():
    out = subprocess.run([sys.executable, "-c", _ISOLATION],
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_entry_points_refuse_the_cpu_by_default(monkeypatch):
    """With no card, the default device is an error, never a silent CPU
    run; device="cpu" is the only way onto the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CoocIndex()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryContext.from_docs([[0, 1]], 2)
    cpu_ctx = QueryContext.from_docs([[0, 1]], 2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CoocEngine(cpu_ctx)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack_docs([[0]], 1)
    assert CoocEngine(cpu_ctx, device="cpu").query([0], depth=1) == {
        (0, 1): 1}
