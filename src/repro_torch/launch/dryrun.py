"""The dry-run driver: ``python -m repro_torch.launch.dryrun``, the port of
``repro.launch.dryrun``.

The reference lowers and compiles each cell for 512 placeholder host
devices and reads FLOPs, bytes and memory from the compiled artifact.
Eager PyTorch has no compile-only phase and no SPMD partitioner, so here
each cell is *planned* on the reference's production mesh, a grid of
``meta`` devices (shapes, shardings, per-device argument and output bytes,
donations, model FLOPs and bytes), then *counted*: its program runs once
on ``meta`` under :class:`repro_torch.launch.roofline.Counter` (FLOPs,
bytes accessed, the peak of live bytes).  No partitioner splits the
program, so a device's share of the FLOPs and bytes is the global count
over the number of chips, and the collective term is not measured.  A
record's ``t_lower_s`` and ``t_compile_s`` read "plan" and "count".

The count is made once a cell, on a one-device ``meta`` mesh (the record
``meta-1x1``), and serves every mesh: no op of a cell reads the mesh.  A
cell whose program needs data on ``meta`` (an ``.item()``, a shape that
depends on the values) ends ``"planned"``, naming the op that stopped it;
its shardings and bytes are still recorded, and where the cell states a
bound program (``CellPlan.bound_fn``) that is counted instead, under
``counts["bound"]``: its peak bounds the cell's, and its FLOPs and
kernel counts are the cell's.

``--host`` runs a cell on the devices present (the card; the mesh of
``make_host_mesh()``) when its planned peak fits (:func:`fits`): seeded
random inputs of the planned shapes drawn there (ids inside their ranges;
the co-occurrence index from the CSL corpus model), a seeded model, one
counted warm-up step, whose FLOPs and kernel counts must equal the
``meta`` count and whose peak must stay within FIT_RESERVE of the planned
one, then 3 timed steps (``t_step_s``, their median by CUDA events) and
``peak_per_device_bytes`` from ``torch.cuda.max_memory_allocated``.  A
cell that does not fit, or whose ``meta`` count stopped with no bound,
is recorded ``"planned"`` with its bytes.

    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes --inproc
    python -m repro_torch.launch.dryrun --all --host        # on the card

Records go to ``results/dryrun_torch/`` (``--out``), one JSON file a
cell, mesh and mode, written atomically.  A sweep exits 1 on any failure.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import multiprocessing
import os
import re
import statistics
import sys
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import CoocConfig
from repro_torch.core.atomic_io import atomic_write_text
from repro_torch.core.inverted_index import PackedIndex
from repro_torch.launch import roofline as RL
from repro_torch.launch.cells import CellPlan, all_cells, arg_tree, plan_cell
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.sharding import NamedSharding, axis_rules

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def _set_mode(mode: str) -> None:
    os.environ["REPRO_UNROLL_SCANS"] = "1" if mode == "unroll" else "0"


#: the fraction of the card's memory a cell's planned peak may take, and
#: the bytes held back beside it (CUDA context, cuBLAS workspaces)
FIT_FRACTION, FIT_RESERVE = 0.9, 2e9
#: timed steps after the counted warm-up step (``t_step_s`` is their median)
TIMED_STEPS = 3
#: worker processes of a sweep
JOBS = max(1, min(8, (os.cpu_count() or 2) - 1))

# what a meta kernel says where the program needs the data's values
_NEEDS_DATA = re.compile(r"meta tensors|Meta tensors|data-independent|"
                         r"data-dependent|data dependent", re.IGNORECASE)


def record_path(out_dir: str, arch: str, shape: str, mesh_name: str,
                mode: str) -> str:
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}__{mode}.json")


def _write(out_dir: Optional[str], rec: Dict) -> None:
    if out_dir:
        # atomic commit: a sweep reads these records back
        fn = record_path(out_dir, rec["arch"], rec["shape"], rec["mesh"],
                         rec["mode"])
        atomic_write_text(fn, json.dumps(rec, indent=1) + "\n")


# ---------------------------------------------------------------------------
# Per-device bytes from the shardings
# ---------------------------------------------------------------------------


def _leaf_bytes(t, sharding) -> int:
    if not isinstance(t, torch.Tensor):
        return 0
    shape = t.shape if sharding is None else sharding.shard_shape(t.shape)
    return math.prod(shape) * t.element_size()


def per_device_bytes(tree, shardings) -> int:
    """The bytes of ``tree`` one device holds under ``shardings`` (a
    matching tree of NamedSharding; None where a subtree has none: every
    device then holds all of it)."""
    tree = arg_tree(tree)
    if shardings is None or isinstance(shardings, NamedSharding):
        if isinstance(tree, torch.Tensor):
            return _leaf_bytes(tree, shardings)
        shardings = None
    if isinstance(tree, dict):
        return sum(per_device_bytes(v, None if shardings is None
                                    else shardings[k])
                   for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(per_device_bytes(v, None if shardings is None
                                    else shardings[i])
                   for i, v in enumerate(tree))
    return 0


def _mem_summary(plan: CellPlan, out) -> Dict:
    """Per-device argument, donated and output bytes from the plan's
    shardings (the reference reads them from the compiled artifact)."""
    mem = {"argument_size_in_bytes": per_device_bytes(list(plan.args),
                                                      list(plan.in_shardings)),
           "alias_size_in_bytes": sum(
               per_device_bytes(plan.args[i], plan.in_shardings[i])
               for i in plan.donate_argnums)}
    if out is not None:
        mem["output_size_in_bytes"] = per_device_bytes(out,
                                                       plan.out_shardings)
    return mem


# ---------------------------------------------------------------------------
# Counting on meta
# ---------------------------------------------------------------------------


def _count(c: RL.Counter, fn, args):
    with c:
        c.track(list(args))
        return fn(*args)


def count_plan(plan: CellPlan) -> Tuple[RL.Counter, object, str,
                                        Optional[RL.Counter]]:
    """Run the plan's program once under a Counter.  Returns (counter, the
    outputs, "", None) or, where a ``meta`` program needs the data's
    values, (counter so far, None, the op that stopped it and why, the
    count of the plan's bound program, None where it states none)."""
    c = RL.Counter()
    try:
        out = _count(c, plan.fn, plan.args)
    except (NotImplementedError, RuntimeError) as e:
        if not _NEEDS_DATA.search(str(e)):
            raise
        first = str(e).strip().splitlines()[0].split(". ")[0]
        bound = None
        if plan.bound_fn is not None:
            bound = RL.Counter()
            _count(bound, plan.bound_fn, plan.args)
        return c, None, f"{c.last_op} needs the data's values ({first})", \
            bound
    return c, out, "", None


def cell_record(plan: CellPlan, mesh, mesh_name: str, mode: str, counted,
                t_plan: float, t_count: float) -> Dict:
    """The record of one cell on one mesh from its plan and its count
    (``count_plan``'s four values)."""
    c, out, reason, bound = counted
    n_chips = mesh.size
    rec = {
        "arch": plan.arch, "shape": plan.shape, "kind": plan.kind,
        "mesh": mesh_name, "mode": mode, "n_chips": n_chips,
        "status": "planned" if reason else "ok",
        "t_lower_s": round(t_plan, 2), "t_compile_s": round(t_count, 2),
        "model_flops": plan.model_flops, "model_bytes": plan.model_bytes,
        "memory": _mem_summary(plan, out),
        "counts": dict(c.to_dict(), complete=not reason,
                       bound=None if bound is None else bound.to_dict()),
        "roofline": None, "note": plan.note,
    }
    if isinstance(get_config(plan.arch), CoocConfig):
        rec["method"] = os.environ.get("REPRO_COOC_METHOD", "gemm")
    if reason:
        rec["reason"] = reason
    else:
        rec["roofline"] = RL.from_counts(c, n_chips, plan.model_flops,
                                         plan.model_bytes).to_dict()
    notes = [plan.note] if plan.note else []
    if n_chips > 1:
        notes.append("per-device FLOPs and bytes are the global count over "
                     f"{n_chips} chips: no partitioner splits the program")
    rec["note"] = "; ".join(notes)
    return rec


def _say(rec: Dict) -> None:
    tag = (f"[{rec['arch']} x {rec['shape']} @ {rec['mesh']} "
           f"({rec['mode']})]")
    mem = rec["memory"]
    if rec["status"] != "ok":
        print(f"{tag} PLANNED  {rec.get('reason', '')}")
        peak = planned_peak(rec)
        print(f"  args/device {mem['argument_size_in_bytes'] / 2**30:.3f} GiB"
              "  planned peak " + ("none" if peak is None else
                                   f"{peak / 2**30:.3f} GiB"))
        return
    rl = rec["roofline"]
    print(f"{tag} OK  plan {rec['t_lower_s']:.1f}s count "
          f"{rec['t_compile_s']:.1f}s")
    print(f"  args/device {mem['argument_size_in_bytes'] / 2**30:.3f} GiB  "
          f"program peak {rec['counts']['peak_bytes'] / 2**30:.3f} GiB")
    print(f"  flops/dev {rl['flops_per_dev']:.3e}  kernel ops/dev "
          f"{rl['kernel_ops_per_dev']:.3e}  bytes/dev "
          f"{rl['hbm_bytes_per_dev']:.3e}  coll/dev "
          f"{rl['coll_bytes_per_dev']}")
    print(f"  t_compute {rl['t_compute_s'] * 1e3:.2f} ms  t_memory "
          f"{rl['t_memory_s'] * 1e3:.2f} ms  -> {rl['bottleneck']}-bound")
    print(f"  MODEL_FLOPS {rl['model_flops']:.3e}  useful "
          f"{rl['useful_ratio']:.3f}  roofline-fraction "
          f"{rl['roofline_fraction']:.3f}")
    if "t_step_s" in rec:
        peak = mem.get("peak_per_device_bytes")
        print(f"  t_step {rec['t_step_s'] * 1e3:.2f} ms  peak/device "
              + ("not measured" if peak is None else
                 f"{peak / 2**30:.3f} GiB"))


def plan_records(arch: str, shape: str, multi_pods: Sequence[bool],
                 out_dir: Optional[str], mode: str = "unroll",
                 verbose: bool = True) -> List[Dict]:
    """Plan one cell on a one-device ``meta`` mesh (``meta-1x1``) and count
    it there once, then plan it on each production mesh of ``multi_pods``
    with that count.  Returns the records (written to ``out_dir``)."""
    _set_mode(mode)
    meshes = [(make_host_mesh("meta"), "meta-1x1")]
    meshes += [(make_production_mesh(multi_pod=mp),
                "2x16x16" if mp else "16x16") for mp in multi_pods]
    counted, t_count, recs = None, 0.0, []
    for mesh, name in meshes:
        t0 = time.time()
        with axis_rules(mesh):
            plan = plan_cell(arch, shape)
            t_plan = time.time() - t0
            if counted is None:
                counted = count_plan(plan)
                t_count = time.time() - t0 - t_plan
        rec = cell_record(plan, mesh, name, mode, counted, t_plan, t_count)
        del plan
        _write(out_dir, rec)
        if verbose:
            _say(rec)
        recs.append(rec)
    return recs


# ---------------------------------------------------------------------------
# Running on the devices present
# ---------------------------------------------------------------------------


def card_budget(device) -> float:
    """The bytes a cell's planned peak may take on ``device`` (a card: the
    FIT_FRACTION of its memory less FIT_RESERVE; the CPU: no limit)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return math.inf
    total = torch.cuda.get_device_properties(dev).total_memory
    return FIT_FRACTION * total - FIT_RESERVE


def meta_counts(meta_rec: Dict) -> Optional[Dict]:
    """The counts a cell's ``meta`` record plans with: its program's, or
    where that run stopped on data, its bound program's; None where the
    cell states no bound."""
    counts = meta_rec["counts"]
    return counts if counts["complete"] else counts.get("bound")


def planned_peak(meta_rec: Dict) -> Optional[int]:
    """The program's planned peak on one device: the live bytes of its
    ``meta`` run, arguments included (of its bound program where the run
    stopped on data); None where nothing bounds it."""
    counts = meta_counts(meta_rec)
    return None if counts is None else counts["peak_bytes"]


def fits(meta_rec: Dict, device) -> bool:
    """The fit rule: a planned peak (:func:`planned_peak`), within
    :func:`card_budget`.  A cell whose ``meta`` count stopped and which
    states no bound does not fit: a peak up to the stop bounds nothing."""
    peak = planned_peak(meta_rec)
    return peak is not None and peak <= card_budget(device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, args, dev: torch.device) -> float:
    """Seconds of one call, by CUDA events on a card."""
    if dev.type == "cuda":
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn(*args)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / 1e3
    t = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t


#: elements checked at a time for a NaN or inf (``torch.isfinite`` makes
#: temporaries of twice the checked bytes and more)
FINITE_CHUNK = 1 << 28


def _all_finite(t: torch.Tensor) -> bool:
    flat = t.detach().reshape(-1)
    return all(bool(torch.isfinite(flat[i:i + FINITE_CHUNK]).all())
               for i in range(0, flat.numel(), FINITE_CHUNK))


def nonfinite_outputs(out, path: str = "") -> List[str]:
    """The paths of the outputs' floating tensors (a module's parameters
    included) that hold a NaN or inf."""
    if isinstance(out, torch.nn.Module):
        out = dict(out.named_parameters())
    if isinstance(out, dict):
        return [b for k, v in out.items()
                for b in nonfinite_outputs(v, f"{path}[{k!r}]")]
    if isinstance(out, (list, tuple)):
        return [b for i, v in enumerate(out)
                for b in nonfinite_outputs(v, f"{path}[{i}]")]
    if isinstance(out, torch.Tensor) and out.is_floating_point() and \
            not _all_finite(out):
        return [path]
    return []


def host_cell(arch: str, shape: str, meta_rec: Dict, *, device=None,
              mode: str = "unroll", seed: int = 0,
              out_dir: Optional[str] = None, verbose: bool = True,
              keep_output: bool = False):
    """Run one cell on ``device`` (default: the card) at full size when
    :func:`fits` says so.  ``meta_rec`` is the cell's ``meta-1x1`` record.
    Returns (record, outputs if ``keep_output``).  Raises where the card's
    FLOPs or kernel counts differ from the ``meta`` count, its peak passes
    the planned one by more than FIT_RESERVE, or an output is not
    finite."""
    _set_mode(mode)
    mesh = make_host_mesh(device)
    dev = mesh.devices.flat[0]
    suffix = "" if meta_rec.get("method", "gemm") == "gemm" \
        else "-" + meta_rec["method"]
    name = "host-" + "x".join(map(str, mesh.devices.shape)) + suffix
    planned = planned_peak(meta_rec)
    if not fits(meta_rec, dev):
        why = ("its meta count stopped on data and it states no bound"
               if planned is None else f"planned peak {planned} bytes does "
               f"not fit {card_budget(dev):.0f}")
        rec = dict(meta_rec, mesh=name, n_chips=mesh.size, status="planned",
                   reason=why, roofline=None)
        _write(out_dir, rec)
        if verbose:
            _say(rec)
        return rec, None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    with axis_rules(mesh):
        plan = plan_cell(arch, shape, device=dev, seed=seed)
        _sync(dev)
        t_plan = time.time() - t0
        if dev.type == "cuda":
            # the step's peak: not the drawing of its inputs, nor the
            # finiteness check after it
            torch.cuda.reset_peak_memory_stats(dev)
        with RL.Counter() as c:
            out = plan.fn(*plan.args)
            _sync(dev)
        t_count = time.time() - t0 - t_plan
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else None
        bad = nonfinite_outputs(out)
        if bad:
            raise AssertionError(f"{arch} x {shape}: outputs not finite on "
                                 f"{dev}: {bad[:5]}")
        rec = cell_record(plan, mesh, name, mode, (c, out, "", None),
                          t_plan, t_count)
        idx = plan.args[0]
        if isinstance(idx, PackedIndex):
            # the share of postings bits set, which kernels 1 and 2's
            # work follows (they skip zero mask words)
            rec["postings_density"] = int(idx.doc_freq.sum()) / (
                max(1, int(idx.n_docs)) * idx.vocab_size)
        if not keep_output:
            out = None
        times = [_timed(plan.fn, plan.args, dev) for _ in range(TIMED_STEPS)]
    if peak is not None:
        rec["memory"]["peak_per_device_bytes"] = int(peak)
    rec["t_step_s"] = statistics.median(times)
    rec["planned_peak_bytes"] = planned
    want = meta_counts(meta_rec)
    rec["meta_flops"], rec["meta_kernels"] = want["flops"], want["kernels"]
    del plan
    got = rec["counts"]
    if (got["flops"], got["kernels"]) != (want["flops"], want["kernels"]):
        raise AssertionError(f"{arch} x {shape}: {got['flops']} FLOPs on "
                             f"{dev}, {want['flops']} on meta; kernels "
                             f"{got['kernels']} on {dev}, {want['kernels']} "
                             "on meta")
    if peak is not None and peak > planned + FIT_RESERVE:
        raise AssertionError(f"{arch} x {shape}: peak {peak} bytes on {dev}, "
                             f"planned {planned}: the fit rule does not "
                             "bound it")
    for k in ("model_flops", "model_bytes"):
        if rec[k] != meta_rec[k]:
            raise AssertionError(f"{arch} x {shape}: {k} {rec[k]} on {dev}, "
                                 f"{meta_rec[k]} on meta")
    _write(out_dir, rec)
    if verbose:
        _say(rec)
    return rec, out


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             verbose: bool = True, mode: str = "unroll", *,
             host: bool = False) -> dict:
    """Plan (and count) one cell on the production mesh; with ``host``, on
    a one-device ``meta`` mesh and then on the devices present.  Returns
    the last record."""
    if host:
        meta_rec, = plan_records(arch, shape, (), out_dir, mode, verbose)
        return host_cell(arch, shape, meta_rec, mode=mode, out_dir=out_dir,
                         verbose=verbose)[0]
    return plan_records(arch, shape, (multi_pod,), out_dir, mode,
                        verbose)[-1]


def _cached_ok(out_dir: str, arch: str, shape: str, names, mode) -> bool:
    for name in names:
        fn = record_path(out_dir, arch, shape, name, mode)
        if not os.path.exists(fn):
            return False
        with open(fn) as f:
            if json.load(f).get("status") not in ("ok", "planned"):
                return False
    return True


def run_all(multi_pod_modes, out_dir: str, mode: str,
            subprocess_mode: bool = True, *, host: bool = False,
            verbose: bool = True, cells=None) -> int:
    """Plan every cell (or ``cells``, (arch, shape) pairs) on each mesh of
    ``multi_pod_modes`` (each cell's meshes in one process, which counts it
    once), in JOBS worker processes unless ``subprocess_mode`` is False: a
    worker takes cell after cell, so the import and the first ``meta``
    dispatch are paid once a worker, and a cell that crashes its worker
    fails the sweep.  With ``host``, then run each cell on the devices
    present, one at a time.  ``verbose`` False prints only failures and
    the summary.  Returns 1 on any failure."""
    failures = []
    cells = list(all_cells() if cells is None else cells)
    names = ["meta-1x1"] + ["2x16x16" if mp else "16x16"
                            for mp in multi_pod_modes]
    todo = []
    for arch, shape in cells:
        if _cached_ok(out_dir, arch, shape, names, mode):
            if verbose:
                print(f"[{arch} x {shape} ({mode})] cached")
        else:
            todo.append((arch, shape))
    if subprocess_mode and todo:
        spawn = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                min(JOBS, len(todo)), mp_context=spawn) as pool:
            runs = {cell: pool.submit(plan_records, *cell,
                                      list(multi_pod_modes), out_dir, mode,
                                      False) for cell in todo}
            for (arch, shape), fut in runs.items():
                try:
                    recs = fut.result()
                except Exception:
                    print(f"[{arch} x {shape} ({mode})] FAILED:")
                    traceback.print_exc()
                    failures.append(f"{arch} x {shape}")
                    continue
                if verbose:
                    for rec in recs:
                        _say(rec)
    else:
        for arch, shape in todo:
            try:
                plan_records(arch, shape, multi_pod_modes, out_dir, mode,
                             verbose)
            except Exception:
                traceback.print_exc()
                failures.append(f"{arch} x {shape}")
    n = len(cells) * len(names)
    if host:
        for arch, shape in cells:
            tag = f"{arch} x {shape} @ host"
            fn = record_path(out_dir, arch, shape, "meta-1x1", mode)
            if not os.path.exists(fn):
                failures.append(tag)
                continue
            with open(fn) as f:
                meta_rec = json.load(f)
            try:
                host_cell(arch, shape, meta_rec, mode=mode, out_dir=out_dir,
                          verbose=verbose)
            except Exception:
                traceback.print_exc()
                failures.append(tag)
            n += 1
    print(f"\n=== dry-run sweep ({mode}): {len(failures)} failures of "
          f"{n} records ===")
    for f in failures:
        print("  FAIL:", f)
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="dry-run driver")
    ap.add_argument("--arch", default=None, choices=list_archs())
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="sweep every cell")
    ap.add_argument("--both-meshes", action="store_true",
                    help="sweep single-pod AND multi-pod")
    ap.add_argument("--mode", choices=("scan", "unroll"),
                    default=os.environ.get("REPRO_DRYRUN_MODE", "unroll"))
    ap.add_argument("--out", default=os.path.normpath(RESULTS_DIR))
    ap.add_argument("--inproc", action="store_true",
                    help="with --all: no per-cell subprocesses")
    ap.add_argument("--host", action="store_true",
                    help="also run each cell that fits on the devices "
                         "present (the card)")
    args = ap.parse_args(argv)

    modes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        return run_all(modes, args.out, args.mode,
                       subprocess_mode=not args.inproc, host=args.host)

    assert args.arch and args.shape, "--arch and --shape (or --all)"
    if args.host:
        run_cell(args.arch, args.shape, False, args.out, mode=args.mode,
                 host=True)
    else:
        plan_records(args.arch, args.shape, modes, args.out, args.mode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
