"""The control of the correctness check: the reference put in the
program's place, its counts carried in float16, run through the harness
at a cell's own size.

    python -m portbench.control --workload <cell> --seeds 1,2,3 \\
        [--seconds 5] [--precision float16]

For each seed it runs the cell as a benchmark run runs it
(:func:`portbench.harness.run`), with every answer the program hands out
replaced, where it is produced, by the reference's answer at
``--precision``: each query's network as ``CoocEngine.step`` finishes it
(the batch loop and the server's lanes alike), each network row that
``materialize`` returns.  The program still runs, so the window has its
own load; the reference draws the cell's documents from the seed itself
and answers over the documents live at each answer's epoch.  Each run's
result line is printed; the control is caught when ``correct`` is false.
A benchmark run never runs this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from portbench import harness, reference
from portbench.systems import cooc


class _Reference:
    """The reference's answers at ``precision`` over a run's documents
    (the window's stream too), its index built on first use.  ``epochs``
    maps a context epoch to the ingests that the server had made by
    then."""

    def __init__(self, cfg: Mapping, traffic: Mapping, seed: int,
                 seconds: float, device, precision: str):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.seconds, self.device, self.precision = seconds, device, precision
        self.epochs: Dict[int, int] = {}
        self.n_ingests = 0
        self._index: Optional[reference.Index] = None
        self._rows: Dict[int, tuple] = {}

    @property
    def index(self) -> reference.Index:
        if self._index is None:
            docs = cooc.corpus_docs(self.cfg, self.seed, self.device)
            stream = cooc.stream_docs(self.cfg, self.traffic, self.seed,
                                      self.seconds, self.device)
            if stream is not None:
                docs = torch.cat([docs, stream])
            self._index = reference.Index(docs, int(self.cfg["vocab_size"]))
        return self._index

    def docs_at(self, epoch: int):
        """[lo, hi) of the documents live at ``epoch``."""
        n_fill = int(self.cfg["n_docs"])
        win = self.cfg.get("window")
        if not win:
            return 0, n_fill
        return cooc.live_range(n_fill, int(win["block"]), int(win["docs"]),
                               self.epochs[epoch])

    def query(self, spec, epoch: int) -> List[tuple]:
        lo, hi = self.docs_at(epoch)
        return reference.bfs(self.index, [list(spec.seeds)],
                             depth=spec.depth, topk=spec.topk,
                             beam=spec.beam, lo=[lo], hi=[hi],
                             precision=self.precision)[0]

    def rows(self, terms: np.ndarray, k: int):
        """(dst, weight) of network rows ``terms``, each row worked out
        once."""
        todo = [int(t) for t in terms if int(t) not in self._rows]
        if todo:
            dst, wt = reference.network_rows(self.index, todo, k,
                                             precision=self.precision)
            for i, t in enumerate(todo):
                self._rows[t] = (dst[i], wt[i])
        return (np.stack([self._rows[int(t)][0] for t in terms]),
                np.stack([self._rows[int(t)][1] for t in terms]))


class _Answer:
    """A served query's network as the reference gives it, in the
    engine's host layout, worked out when first read."""

    def __init__(self, ref: _Reference, spec, epoch: int):
        self._ref, self._spec, self._epoch = ref, spec, epoch
        self._arrays = None

    def _get(self, i: int) -> np.ndarray:
        if self._arrays is None:
            e = np.asarray(self._ref.query(self._spec, self._epoch),
                           np.int64).reshape(-1, 3)
            self._arrays = (e[:, 0], e[:, 1], e[:, 2],
                            np.ones(len(e), bool))
        return self._arrays[i]

    src = property(lambda self: self._get(0))
    dst = property(lambda self: self._get(1))
    weight = property(lambda self: self._get(2))
    valid = property(lambda self: self._get(3))


class _Slots:
    """One field of a whole network (``"dst"``, ``"weight"`` or
    ``"src"``), indexed by flat slot (``term * k + rank``) as the program's
    tensors are: the reference's rows, worked out for the slots read."""

    def __init__(self, ref: _Reference, k: int, field: str):
        self._ref, self._k, self._field = ref, k, field

    def __getitem__(self, slots: torch.Tensor) -> torch.Tensor:
        flat = slots.reshape(-1).cpu().numpy()
        term, rank = flat // self._k, flat % self._k
        if self._field == "src":
            return torch.as_tensor(term)
        uniq = np.unique(term)
        dst, wt = self._ref.rows(uniq, self._k)
        pos = np.searchsorted(uniq, term)
        got = dst if self._field == "dst" else wt
        return torch.as_tensor(got[pos, rank])


class _Network:
    def __init__(self, ref: _Reference, k: int):
        self.dst = _Slots(ref, k, "dst")
        self.weight = _Slots(ref, k, "weight")
        self.src = _Slots(ref, k, "src")


@contextlib.contextmanager
def planted(ref: _Reference):
    """While open, the program's answers are the reference's: the
    engine's finished queries and ``materialize``'s networks.  The epochs
    of the server's ingests are recorded for the window's live range."""
    import repro_torch.core as core
    from repro_torch.serve.cooc_engine import CoocEngine
    step, ingest_docs, materialize = (CoocEngine.step,
                                      CoocEngine.ingest_docs,
                                      core.materialize)

    def planted_step(engine):
        ref.epochs.setdefault(engine.ctx.epoch, ref.n_ingests)
        n = step(engine)
        for r in list(engine.finished)[-n:] if n else []:
            if r.result is not None:
                r.result.network = _Answer(ref, r.spec, r.result.epoch)
        return n

    def planted_ingest(engine, *a, **kw):
        out = ingest_docs(engine, *a, **kw)
        ref.n_ingests += 1
        ref.epochs[engine.ctx.epoch] = ref.n_ingests
        return out

    def planted_materialize(ctx, *, k, **kw):
        materialize(ctx, k=k, **kw)
        return _Network(ref, k)

    CoocEngine.step = planted_step
    CoocEngine.ingest_docs = planted_ingest
    core.materialize = planted_materialize
    try:
        yield ref
    finally:
        CoocEngine.step, CoocEngine.ingest_docs = step, ingest_docs
        core.materialize = materialize


def control(name: str, seed: int, precision: str, device,
            root: Path = harness.ROOT, base: Path = harness.BASE,
            seconds: float = 5.0) -> dict:
    """The result line of one run of cell ``name`` with the reference at
    ``precision`` in the program's place."""
    spec = harness.load_spec(root)
    cell = harness.workload(spec, name)
    cfg = harness._json(base, "configs", cell["config"])
    traffic = harness._json(base, "traffic", cell["traffic"])
    ref = _Reference(cfg, traffic, seed, seconds, device, precision)
    with planted(ref):
        return harness.run(name, seed=seed, seconds=seconds, trace=False,
                           t_start=time.monotonic(), root=root, base=base,
                           device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--precision", default="float16")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(harness.ROOT / "src"))
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    for s in args.seeds.split(","):
        t0 = time.monotonic()
        line = control(args.workload, int(s), args.precision, device,
                       seconds=args.seconds)
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "precision": args.precision,
                          "correct": line["correct"],
                          "checks": {k: c["value"] for k, c
                                     in line["checks"].items()},
                          "seconds": time.monotonic() - t0}), flush=True)
        if device != "cpu":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
