"""The harness: finds a cell's pieces by name, runs it, prints its line.

Everything a cell needs is found by the names in ``BENCHMARK.json``, in
files of their own, so that a later change adds a configuration, a
traffic mix, a cell or a per-layer metric as new files:

* ``configs/<config>.json``: the deployment; its ``"system"`` names the
  module ``systems/<system>.py`` that runs it;
* ``traffic/<traffic>.json``: the mix, read by the system module's
  general generator (its ``"loop"`` picks the loop);
* ``cells/<workload>.json``: what the cell's check samples, and how its
  load was chosen;
* ``metrics/<metric>.py``: one reader per per-layer metric, a function
  ``read(obs)`` that returns the number, or None where it finds nothing.

The run's result is one JSON line on standard output, its last; before
it, the numbers that decided ``correct``, each beside its limit, are the
last lines on standard error.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Mapping, Optional

import torch

BASE = Path(__file__).resolve().parent
ROOT = BASE.parent
#: top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunError(RuntimeError):
    """The run cannot print a result (no card, a missing piece, a
    forbidden import)."""


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def workload(spec: Mapping, name: str) -> Mapping:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise RunError(f"no workload {name!r} in BENCHMARK.json")


def _json(base: Path, kind: str, name: str) -> dict:
    path = Path(base) / kind / f"{name}.json"
    if not path.exists():
        raise RunError(f"missing {kind} file {path}")
    return json.loads(path.read_text())


def end_to_end(spec: Mapping, cell: str) -> List[Mapping]:
    """The end-to-end metrics cell ``cell`` reports."""
    return [m for m in spec["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer(spec: Mapping, cell: str) -> List[Mapping]:
    """The per-layer metrics of cell ``cell``: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    names = {m["name"] for m in end_to_end(spec, cell)}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(base: Path, name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = Path(base) / "metrics" / f"{name}.py"
    if not path.exists():
        raise RunError(f"missing metric reader {path}")
    mod_name = "portbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Forbidden top-level names that ``sys.modules`` holds, each compared
    whole (``repro_torch`` is not ``repro``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def device_info(device, chips: int, peak_bytes: int) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": chips, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": dev.type, "kind": dev.type, "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def run(name: str, *, seed: int, seconds: float, trace: bool,
        t_start: float, root: Path = ROOT, base: Path = BASE,
        device: Optional[str] = None) -> dict:
    """Run workload ``name`` once and return its result line (a dict).
    ``device=None`` runs on the card, after checking that there is one
    and enough of them; a test passes ``"cpu"``."""
    spec = load_spec(root)
    cell = workload(spec, name)
    chips = int(cell["chips"])
    if device is None:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: torch.cuda.is_available() is "
                           "false")
        if torch.cuda.device_count() < chips:
            raise RunError(f"the cell needs {chips} cards, "
                           f"{torch.cuda.device_count()} are visible")
        device = "cuda:0"
    cfg = _json(base, "configs", cell["config"])
    traffic = _json(base, "traffic", cell["traffic"])
    cell_file = _json(base, "cells", name)
    want_e2e = [m["name"] for m in end_to_end(spec, name)]
    layer = per_layer(spec, name) if trace else []
    readers = {m["name"]: reader(base, m["name"]) for m in layer}
    system = importlib.import_module(f"portbench.systems.{cfg['system']}")
    out = system.run(cfg, traffic, cell_file, seed=seed, seconds=seconds,
                     trace=trace, device=device, t_start=t_start)
    found = forbidden_modules()
    if found:
        raise RunError("the run loaded " + ", ".join(found)
                       + ": nothing that runs may import the JAX package "
                       "or JAX")
    units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
    units.update({m["name"]: m["unit"] for m in spec["per_layer"]})
    metrics: Dict[str, dict] = {}
    if trace:
        for m in layer:
            value = readers[m["name"]](out.obs)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": units[m["name"]]}
    else:
        missing = [n for n in want_e2e if n not in out.e2e]
        if missing:
            raise RunError(f"the run took no {missing}")
        metrics = {n: {"value": float(out.e2e[n]), "unit": units[n]}
                   for n in want_e2e}
    dev = device_info(device, chips, out.peak_bytes)
    line = {"correct": all(c.ok for c in out.checks),
            "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit,
                               "must_be": ">=" if c.at_least else "<="}
                      for c in out.checks}
    line["_notes"] = out.notes
    return line


def print_line(line: dict) -> None:
    """The notes and the checks on standard error (the checks last), then
    the result as the last line of standard output."""
    notes = line.pop("_notes", {})
    for k, v in notes.items():
        print(f"note {k}={v}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}={c['value']} limit {c['must_be']} {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
