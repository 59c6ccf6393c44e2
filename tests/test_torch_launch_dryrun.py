"""The dry-run driver (``repro_torch.launch.dryrun``) on the CPU: a small
dry-run on ``meta`` (the reference's ``MINI_DRYRUN`` config of
``tests/test_sharding.py``: reduced llama, a (4, 2) mesh, the train and
decode cells), a cell that stops on ``meta`` where it needs the data, the
command line's records, a sweep in worker processes against one in
process, and the fit rule.
"""
import json
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import cells as C  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402


@pytest.fixture(autouse=True)
def _default_knobs(monkeypatch):
    for k in ("REPRO_COOC_METHOD", "REPRO_BUILD_DTYPE", "REPRO_CACHE_DTYPE",
              "REPRO_DECODE_FSDP", "REPRO_UNROLL_SCANS"):
        monkeypatch.delenv(k, raising=False)


MINI = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256, fsdp=True, attn_q_chunk=0)


def test_mini_dryrun_on_a_meta_mesh(monkeypatch):
    """The reference's MINI_DRYRUN: reduced llama on a (4, 2) mesh, its
    train and decode cells planned and counted on ``meta``."""
    import repro_torch.configs.llama3_8b as L
    from repro_torch.configs import base, replace
    monkeypatch.setattr(L, "CONFIG", replace(
        L.CONFIG, **MINI, shapes=(
            base.ShapeSpec("t", "train", dict(seq_len=32, global_batch=8)),
            base.ShapeSpec("d", "decode", dict(seq_len=64, global_batch=8)))))
    monkeypatch.setenv("REPRO_UNROLL_SCANS", "0")
    mesh = M.make_mesh((4, 2), ("data", "model"), ["meta"] * 8)
    for shp in ("t", "d"):
        with S.axis_rules(mesh):
            plan = C.plan_cell("llama3-8b", shp)
            counted = DR.count_plan(plan)
        rec = DR.cell_record(plan, mesh, "4x2", "scan", counted, 0.0, 0.0)
        assert rec["status"] == "ok" and rec["n_chips"] == 8
        rl = rec["roofline"]
        assert rl["coll_bytes_per_dev"] is None
        assert rl["collective_note"] == "no partitioner"
        assert rl["flops_per_dev"] * 8 == rec["counts"]["flops"] > 0
        mem = rec["memory"]
        assert 0 < mem["argument_size_in_bytes"] < DR.per_device_bytes(
            list(plan.args), None)
        if shp == "t":
            assert 0 < rl["useful_ratio"] <= 1
            assert mem["alias_size_in_bytes"] > 0


def test_a_planned_cell_names_the_op_that_needs_data(tmp_path, monkeypatch):
    """The ingest cell stops on ``meta`` at the boolean index of its new
    docs; its shardings and bytes are recorded all the same, and its bound
    program is counted: the ingest's output index beside the arguments,
    the query's kernels."""
    import repro_torch.configs.cooccur_csl as CC
    from repro_torch.configs import replace
    monkeypatch.setattr(CC, "CONFIG", replace(CC.CONFIG, vocab_size=256,
                                              n_docs=1500))
    recs = DR.plan_records("cooccur-csl", "stream_ingest", (False, True),
                           str(tmp_path), "scan", verbose=False)
    assert [r["mesh"] for r in recs] == ["meta-1x1", "16x16", "2x16x16"]
    for r in recs:
        assert r["status"] == "planned" and r["roofline"] is None
        assert re.match(r"aten\.\w+\.\w+ needs the data's values",
                        r["reason"])
        assert r["memory"]["argument_size_in_bytes"] > 0
        assert not r["counts"]["complete"]
    bound = recs[0]["counts"]["bound"]
    index_bytes = (1500 + 31) // 32 * 256 * 4 + 256 * 4 + 4
    args = recs[0]["memory"]["argument_size_in_bytes"]
    assert bound["peak_bytes"] >= args + index_bytes + \
        C.INGEST_TEMPS * 4096 * 64 * 8
    assert DR.planned_peak(recs[0]) == bound["peak_bytes"]
    assert DR.planned_peak(recs[0]) > recs[0]["counts"]["peak_bytes"]
    assert len(list(tmp_path.iterdir())) == 3


def test_dryrun_cli_writes_one_record_a_mesh(tmp_path):
    rc = DR.main(["--arch", "gin-tu", "--shape", "molecule", "--both-meshes",
                  "--mode", "scan", "--out", str(tmp_path)])
    assert rc == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"gin-tu__molecule__{m}__scan.json"
                     for m in ("16x16", "2x16x16", "meta-1x1")]
    recs = {n: json.loads((tmp_path / n).read_text()) for n in names}
    flops = {r["counts"]["flops"] for r in recs.values()}
    assert len(flops) == 1                       # one count serves each mesh
    for r in recs.values():
        assert r["status"] == "ok" and set(r) >= {
            "memory", "roofline", "t_lower_s", "t_compile_s", "note"}
        assert r["roofline"]["flops_per_dev"] * r["n_chips"] == \
            pytest.approx(r["counts"]["flops"], rel=1e-12)


def test_sweep_in_worker_processes_matches_in_process(tmp_path):
    """Two spawned workers plan three cells as one process does, and a
    cached record is not planned again."""
    cells = [("gin-tu", "molecule"), ("deepfm", "serve_p99"),
             ("sasrec", "retrieval_cand")]
    old = DR.JOBS
    DR.JOBS = 2
    try:
        assert DR.run_all([False], str(tmp_path / "w"), "scan",
                          verbose=False, cells=cells) == 0
    finally:
        DR.JOBS = old
    assert DR.run_all([False], str(tmp_path / "p"), "scan",
                      subprocess_mode=False, verbose=False, cells=cells) == 0
    for arch, shape in cells:
        for mesh in ("meta-1x1", "16x16"):
            a, b = (json.loads(open(DR.record_path(str(tmp_path / d), arch,
                                                   shape, mesh, "scan"))
                               .read()) for d in ("w", "p"))
            assert a["counts"] == b["counts"] and a["memory"] == b["memory"]
    assert DR.run_all([False], str(tmp_path / "p"), "scan",
                      subprocess_mode=False, verbose=True, cells=cells) == 0


def test_fit_rule():
    rec = {"counts": {"peak_bytes": 10, "complete": True}}
    assert DR.fits(rec, "cpu") and DR.card_budget("meta") == float("inf")
    # a count that stopped on data bounds nothing: the bound program's
    # peak plans, and with no bound the cell does not fit
    stopped = {"counts": {"peak_bytes": 10, "complete": False, "bound": None}}
    assert DR.planned_peak(stopped) is None and not DR.fits(stopped, "cpu")
    stopped["counts"]["bound"] = {"peak_bytes": 30}
    assert DR.planned_peak(stopped) == 30 and DR.fits(stopped, "cpu")
