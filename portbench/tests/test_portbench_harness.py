"""The harness on the CPU: pieces found by name, the result line's keys,
and the runs that must print no result."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from conftest import ROOT, SEED
from portbench import harness

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _tree_hash(d):
    h = hashlib.sha256()
    for p in sorted(d.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(d)).encode() + p.read_bytes())
    return h.hexdigest()


def test_new_config_cell_traffic_and_metric_as_files_alone(tiny):
    """A configuration, a traffic mix, a cell and a per-layer metric,
    each added as a new file, and BENCHMARK.json's new entries: the harness
    runs the cell and reports the metric, with no file edited."""
    root, base = tiny
    before = _tree_hash(ROOT / "portbench")
    cfg = json.loads((base / "configs" / "cooccur-csl.json").read_text())
    cfg.update(n_docs=2000, vocab_size=256)
    (base / "configs" / "tiny-corpus.json").write_text(json.dumps(cfg))
    (base / "traffic" / "one-head-d2.json").write_text(json.dumps({
        "loop": "open", "rate_per_s": 30.0, "head_terms": 1,
        "tail_df": [1, 16], "plan": {"depth": 2, "topk": 8, "beam": 8}}))
    (base / "cells" / "tiny-tail.json").write_text(json.dumps(
        {"check": {"sample": 8}}))
    (base / "metrics" / "served_share.tiny.py").write_text(
        "def read(obs):\n"
        "    st = obs.get('statuses')\n"
        "    return 100.0 * st.count('ok') / len(st) if st else None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-corpus", "source": "a test",
                            "file": "portbench/configs/tiny-corpus.json",
                            "reduced": ["n_docs", "vocab_size"],
                            "why": "a test"})
    spec["workloads"].append({"name": "tiny-tail", "config": "tiny-corpus",
                              "traffic": "one-head-d2", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "query_p95_ms":
            m["workloads"].append("tiny-tail")
    spec["per_layer"].append({"name": "served_share.tiny", "unit": "%",
                              "better": "higher",
                              "source": "program_counter", "layer": "server",
                              "moves": "query_p95_ms",
                              "workloads": ["tiny-tail"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    line = harness.run("tiny-tail", seed=SEED, seconds=1.0, trace=False,
                       t_start=time.monotonic(), root=root, base=base,
                       device="cpu")
    assert line["correct"] is True
    assert set(line["metrics"]) == {"query_p95_ms", "device_peak_gb",
                                    "setup_s"}
    traced = harness.run("tiny-tail", seed=SEED + 1, seconds=1.0,
                         trace=True, t_start=time.monotonic(), root=root,
                         base=base, device="cpu")
    assert traced["correct"] is True
    assert set(traced["metrics"]) == {"served_share.tiny"}
    assert traced["metrics"]["served_share.tiny"]["value"] == 100.0
    assert _tree_hash(ROOT / "portbench") == before


def test_metrics_of_a_cell():
    spec = harness.load_spec(ROOT)
    assert [m["name"] for m in harness.end_to_end(spec, "csl-network")] == \
        ["network_s", "device_peak_gb", "setup_s"]
    layer = {m["name"] for m in harness.per_layer(spec, "csl-batch")}
    assert layer == {"step_host_ms.batch", "bfs_roofline.batch",
                     "idle_share.batch"}
    for m in spec["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(tiny, trace, capsys):
    root, base = tiny
    line = harness.run("csl-network", seed=SEED, seconds=0.5, trace=trace,
                       t_start=time.monotonic(), root=root, base=base,
                       device="cpu")
    harness.print_line(line)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    keys = list(last)
    want = CONTRACT_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert keys == want
    assert set(last["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(last["device"])
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, c in last["checks"].items():
        assert set(c) == {"value", "limit", "must_be"}
    # the numbers compared are the last lines of standard error
    tail = err.strip().splitlines()[-len(last["checks"]):]
    assert all(x.startswith("check ") for x in tail)


def _run_cli(cwd, env_extra=None):
    env = dict(os.environ, PYTHONPATH="")
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "csl-network",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints no
    result."""
    r = _run_cli(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, the
    command exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run_cli(tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert "jaxlib" in harness.forbidden_modules()


def test_forbidden_module_loaded_no_result(tiny, monkeypatch):
    root, base = tiny
    monkeypatch.setitem(sys.modules, "jax", object())
    with pytest.raises(harness.RunError, match="jax"):
        harness.run("csl-network", seed=SEED, seconds=0.2, trace=False,
                    t_start=time.monotonic(), root=root, base=base,
                    device="cpu")
