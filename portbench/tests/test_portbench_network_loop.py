"""The network loop's hold on what it built: of each whole network only
the rows the check reads outlive the iteration that built it, so the
device's peak counts the program's memory and no network the harness
kept."""
from __future__ import annotations

import time
import weakref

from conftest import SEED, copies_of_one_network
from portbench import harness


def test_the_loop_keeps_only_the_checked_rows(tiny, monkeypatch):
    """When each ``materialize`` starts, no tensor of an earlier network
    is alive; every network built is still checked, (sample, k) rows
    each."""
    import repro_torch.core as core
    built = copies_of_one_network(core.materialize)
    refs, alive = [], []

    def materialize(*a, **kw):
        alive.append(sum(r() is not None for r in refs))
        net = built(*a, **kw)
        refs.extend(weakref.ref(t) for t in net)
        return net

    monkeypatch.setattr(core, "materialize", materialize)
    root, base = tiny
    line = harness.run("csl-network", seed=SEED, seconds=0.3, trace=False,
                       t_start=time.monotonic(), root=root, base=base,
                       device="cpu")
    assert line["correct"] is True, line["checks"]
    # the set-up's warm network, then two or more in the window
    assert line["attempted"] >= 2 and len(alive) == 1 + line["attempted"]
    assert alive == [0] * len(alive)
    assert line["checks"]["rows_checked"]["value"] == 24 * line["attempted"]
