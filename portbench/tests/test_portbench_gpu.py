"""The harness on the card at a small size, through the hand-written
kernels (``"fused"`` and ``"pallas"``).  Skips without a CUDA card; run
on one with ``python -m pytest portbench/tests -m gpu``."""
from __future__ import annotations

import json
import time

import pytest
import torch

from conftest import SEED
from portbench import harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return "cuda:0"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["csl-search", "csl-window-ingest",
                                  "csl-network", "csl-batch"])
@pytest.mark.parametrize("trace", [False, True])
def test_small_cells_on_the_card(tiny, card, cell, trace):
    root, base = tiny
    for p in list((base / "configs").glob("*.json")) + [
            base / "traffic" / "zipf-d2-batch256.json"]:
        c = json.loads(p.read_text())
        if "server" in c:
            c["server"]["method"] = "fused"
        if "method" in c:
            c["method"] = "fused"
        p.write_text(json.dumps(c))
    line = harness.run(cell, seed=SEED, seconds=1.0, trace=trace,
                       t_start=time.monotonic(), root=root, base=base,
                       device=card)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0


@pytest.mark.gpu
def test_network_peak_does_not_grow_with_the_window(tiny, card):
    """A ``csl-network``-shaped cell on the card (CSL's 65,536 terms over
    50,000 documents, the hand-written sweep): a 1 s window and a 4 s
    window, which build several times as many networks, read the same
    ``device_peak_gb`` within 1 MB, and both are correct.  The peak is the
    program's: the harness keeps no network past its iteration."""
    root, base = tiny
    p = base / "configs" / "cooccur-csl.json"
    c = json.loads(p.read_text())
    c.update(n_docs=50_000, vocab_size=65_536)
    p.write_text(json.dumps(c))
    lines = []
    torch.cuda.init()       # the allocator's statistics exist from here
    # the first run builds the kernels; the two after it are compared
    for seconds in (0.5, 1.0, 4.0):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(card)
        line = harness.run("csl-network", seed=SEED, seconds=seconds,
                           trace=False, t_start=time.monotonic(), root=root,
                           base=base, device=card)
        assert line["correct"] is True, line["checks"]
        lines.append(line)
    short, long = lines[1:]
    assert long["attempted"] > 2 * short["attempted"]
    assert abs(long["device"]["memory_peak_bytes"]
               - short["device"]["memory_peak_bytes"]) <= 10 ** 6
