"""The port's train_lm example on the CPU, at the reference's 125M-param
model with the reference's arguments: 3 steps of 2 x 32 tokens with a
checkpoint, then a second run that resumes from it to step 4.  It has a
file of its own: two runs of that model take most of a worker's share of
the suite's time."""
import pytest

from examples_harness import run_example

pytest.importorskip("torch")


def test_train_lm_trains_checkpoints_and_resumes(tmp_path):
    args = ("--device", "cpu", "--batch", "2", "--seq", "32", "--ckpt-dir",
            str(tmp_path))
    _, out, _ = run_example("torch_train_lm.py", "--steps", "3", *args)
    lines = out.splitlines()
    assert lines[0] == "model: 125M params, 12L x 768"
    assert lines[1].startswith("step    0  loss ")
    assert "loss: " in out and "straggler stats: " in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003"]
    _, out, _ = run_example("torch_train_lm.py", "--steps", "4", *args)
    assert "resumed from checkpoint at step 3" in out
    assert "step    3  loss " in out
    assert "step_00000004" in [p.name for p in tmp_path.iterdir()]
