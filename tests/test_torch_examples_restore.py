"""The port's snapshot_restore, sharded_query and item_cooccur_recsys
examples on the CPU against the reference's scripts (see
``test_torch_examples.py``).  sharded_query's mesh repeats the CPU 8
times where the reference forces 8 host devices; item_cooccur_recsys's
retrieval lines equal the reference's, its SASRec ranking (weights drawn
by each package's own generator) is not compared."""
import pytest

from examples_harness import run_example, same_as_reference, untimed_lines

pytest.importorskip("torch")


@pytest.mark.parametrize("name", ["snapshot_restore", "sharded_query"])
def test_example_prints_the_references_lines(name):
    out = same_as_reference(name)
    assert out.rstrip().endswith(("OK", "[ok]"))


def test_item_cooccur_recsys_retrieves_the_references_candidates():
    _, want, _ = run_example("item_cooccur_recsys.py")
    _, got, _ = run_example("torch_item_cooccur_recsys.py", "--device", "cpu")
    want, got = untimed_lines(want), untimed_lines(got)
    assert got[:2] == want[:2]                 # anchor, candidates, purity
    assert got[2].startswith("top-5 ranked candidates: [")
    assert got[3:] == want[3:]
