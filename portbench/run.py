"""Run one cell of ``BENCHMARK.json``:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Exits 0 after printing the result as the
last line of standard output; exits non-zero and prints no result when
there is no card (or fewer than the cell needs), when a piece of the cell
is missing, or when the run has loaded JAX or the JAX package.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """The program under test from ``src``.  It builds its kernels into
    ``src/repro_torch/kernels/_build`` inside the checkout, so only a
    cell's first run in a checkout builds them."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from portbench import harness
    try:
        line = harness.run(args.workload, seed=args.seed,
                           seconds=args.seconds, trace=bool(args.trace),
                           t_start=T_START)
    except (harness.RunError, ImportError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    harness.print_line(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
