"""Running the repository's example scripts in subprocesses, for
``tests/test_torch_examples*.py``: the reference's ``examples/<name>.py``
and the port's ``examples/torch_<name>.py`` (``--device cpu``)."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# an example runs on this many cores, a different pair for each test
# worker, so that it takes little more of the machine than its worker
CORES = 2


def _cores():
    mine = sorted(os.sched_getaffinity(0))
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    k = int(re.sub(r"\D", "", worker) or 0)
    return {mine[(CORES * k + i) % len(mine)] for i in range(CORES)}
# a line that carries a time, or the temporary directory a run made
_TIMED = re.compile(r"\bms\b|latency_ms|straggler stats")
_TMP_PATH = re.compile(r"saved -> \S+")


def run_example(script, *args, env=None, check=True, timeout=300):
    """(returncode, stdout, stderr) of ``examples/<script>`` run from the
    repository's root with ``src`` on the path and JAX on the CPU."""
    full = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS=str(CORES),
                **(env or {}))
    cores = _cores()
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args], cwd=str(ROOT), env=full, text=True,
                          capture_output=True, timeout=timeout,
                          preexec_fn=lambda: os.sched_setaffinity(0, cores))
    if check:
        assert proc.returncode == 0, (script, proc.stdout[-2000:],
                                      proc.stderr[-4000:])
    return proc.returncode, proc.stdout, proc.stderr


def untimed_lines(stdout):
    """The stdout lines that carry no time, a snapshot's path masked."""
    return [_TMP_PATH.sub("saved -> <path>", line)
            for line in stdout.splitlines() if not _TIMED.search(line)]


def same_as_reference(name, *port_args):
    """The port's example on the CPU prints the reference's lines (those
    that carry no time); returns the port's stdout."""
    _, want, _ = run_example(f"{name}.py")
    _, got, _ = run_example(f"torch_{name}.py", "--device", "cpu",
                            *port_args)
    assert untimed_lines(got) == untimed_lines(want)
    return got
