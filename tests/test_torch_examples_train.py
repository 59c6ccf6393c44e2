"""The port's cooccur_to_gnn example on the CPU, and the examples'
refusal to run without a card unless ``--device cpu`` is given.
cooccur_to_gnn's network equals the reference script's (its GIN weights
are drawn by each package's own generator, so the losses are not
compared).  train_lm is in ``test_torch_examples_lm.py``."""
import numpy as np
import pytest

from examples_harness import run_example

torch = pytest.importorskip("torch")


def test_cooccur_to_gnn_builds_the_references_network():
    _, want, _ = run_example("cooccur_to_gnn.py")
    _, got, _ = run_example("torch_cooccur_to_gnn.py", "--device", "cpu",
                            "--steps", "3")
    want, got = want.splitlines(), got.splitlines()
    assert got[0] == want[0]                   # the network's edges
    steps = [float(line.split()[3]) for line in got[1:-1]]
    assert len(steps) == 2 and np.isfinite(steps).all()
    assert got[-1] == want[-1]


def test_examples_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    rc, _, err = run_example("torch_quickstart.py", check=False)
    assert rc != 0 and "no CUDA device is available" in err
