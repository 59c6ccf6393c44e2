"""The port's examples (``examples/torch_*.py``) on the CPU against the
reference's scripts: quickstart, full_network, streaming_window and
serve_realtime, each run in its own process with ``--device cpu``.  Every
stdout line that carries no time equals the reference's line (the
examples' own checks run inside them; a failed one exits non-zero).
``test_torch_examples_restore.py`` and ``test_torch_examples_train.py``
hold the other five, split so that each file runs within its worker's
share of the suite's time."""
import pytest

from examples_harness import same_as_reference

pytest.importorskip("torch")


@pytest.mark.parametrize("name", ["quickstart", "full_network",
                                  "streaming_window"])
def test_cooccurrence_example_prints_the_references_lines(name):
    out = same_as_reference(name)
    assert "[ok]" in out


def test_serve_realtime_prints_the_references_lines():
    """Its phase-1 line and the metrics' latencies carry times and are
    left out; the shed counts, the ingest's weights and the metrics'
    counters are compared."""
    out = same_as_reference("serve_realtime")
    assert "phase 2: burst of 120 -> 32 served, 88 shed (queue_full)" in out
    assert "server drained and stopped  [ok]" in out
