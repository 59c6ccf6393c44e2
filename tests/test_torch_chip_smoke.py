"""A CPU rehearsal of ``chip_smoke.py``'s phases at a tiny size.

The script needs a CUDA card to run for real.  Here the card's timing and
memory calls are stubbed, the kernel wrappers are told that every tensor is
on the card, and the CUDA launchers are replaced by the kernels' plain
versions, so every phase runs its own control flow, its launch counting,
its oracle checks and its kernels line end to end.  What this cannot show
— that the CUDA sources build and agree with the plain versions — only a
run on the card shows.
"""
import sys
import time
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


class _Event:
    def __init__(self, enable_timing=False):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("chip_smoke", None)
    import chip_smoke
    from repro_torch.kernels import level_step, ops, postings, ref
    for name, value in [
            ("Event", _Event), ("synchronize", lambda *a: None),
            ("reset_peak_memory_stats", lambda *a: None),
            ("max_memory_allocated", lambda *a: 0),
            ("empty_cache", lambda: None),
            ("get_device_properties",
             lambda i: types.SimpleNamespace(multi_processor_count=132))]:
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(torch, "_int_mm", lambda a, b: (
        a.to(torch.int32) @ b.to(torch.int32)))
    monkeypatch.setattr(chip_smoke, "smi", lambda q: "1980 MHz"
                        if q.startswith("clocks") else "stub card, 700 W")
    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(postings, "postings_counts_cuda",
                        ref.postings_counts_ref)
    monkeypatch.setattr(level_step, "level_step_cuda", ref.level_step_ref)
    for name, value in [("CSL_DOCS", 1500), ("CSL_TERMS", 256),
                        ("MID_DOCS", 1024), ("MID_TERMS", 128),
                        ("N_QUERIES", 16)]:
        monkeypatch.setattr(chip_smoke, name, value)
    return chip_smoke


def test_chip_smoke_phases_rehearse_on_the_cpu(smoke, capsys):
    dev = torch.device("cpu")
    smoke.phase_parity(dev)
    smoke.phase_strings(dev)
    ctx, seeds, launches = smoke.phase_csl(dev)
    assert launches == {"level_step": 6, "postings_counts": 6}
    kernels = smoke.phase_kernels(dev, ctx, seeds, launches)
    assert [k["name"] for k in kernels] == ["postings_counts", "level_step"]
    for k in kernels:
        assert set(k) == KEYS
        assert k["max_abs_err"] == 0 and k["launches"] == 6
        assert (ROOT / k["source"]).is_file()
        assert k["bound_ms"] > 0 and k["bound_by"] in ("bytes", "operations")
    out = capsys.readouterr().out
    assert "[csl] method=fused" in out and "[csl] method=pallas" in out


def test_chip_smoke_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("chip_smoke", None)
    import chip_smoke
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out
