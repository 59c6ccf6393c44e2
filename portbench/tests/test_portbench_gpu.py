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
