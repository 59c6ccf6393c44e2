"""Durable snapshot/restore + cold-tier spill, end to end, on the
PyTorch port.

    PYTHONPATH=src python examples/torch_snapshot_restore.py [--device cpu]

The port of ``examples/snapshot_restore.py``, through ``repro_torch``
alone; it runs on the GPU unless ``--device cpu`` is given, and the fresh
process restores onto the same device.  The snapshot's temporary
directory is removed at the end.

1. stream documents through a windowed CoocIndex with a file-backed cold
   store — evicted blocks spill to disk instead of vanishing,
2. query the live window vs ``scope="all-time"`` (live + every spilled
   block, exactly as if nothing was ever evicted),
3. ``save()`` the full index state through the crash-safe commit
   protocol (fsync'd blobs + checksums + atomic CURRENT pointer),
4. ``load()`` it back IN A FRESH PROCESS and verify the restored index
   answers bit-exactly — the in-memory index is the oracle.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

from repro_torch.api import CoocIndex

DOCS = [
    "inverted index maps keywords to documents for fast retrieval",
    "co-occurrence networks reveal semantic structure in text",
    "the index answers keyword queries in real time",
    "keyword networks support text mining and retrieval",
    "real time construction needs no batch rebuild",
    "evicted documents spill to the cold tier on disk",
    "snapshots make the whole index state durable",
    "a restored index answers every query bit exactly",
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    workdir = tempfile.mkdtemp(prefix="cooc-snapshot-")
    try:
        _run(workdir, args.device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)  # cooclint: disable=COOC001 -- the example's own temporary directory


def _run(workdir, device):
    cold_dir = os.path.join(workdir, "cold")
    snap_dir = os.path.join(workdir, "snap")

    # -- build: windowed ingest, evictions spilling to the cold tier ----
    idx = CoocIndex(device=device, window=4, depth=2, topk=4, beam=8,
                    cold_store={"type": "file", "path": cold_dir})
    for lo in range(0, len(DOCS), 2):
        idx.add_documents(DOCS[lo:lo + 2], timestamp=1_700_000_000.0 + lo,
                          source="feed")
    print(f"ingested {len(DOCS)} docs through a window of {idx.window}: "
          f"live={idx.live_docs}, cold blocks={idx.ctx.cold_blocks()}")

    live = idx.full_network(k=4)
    alltime = idx.full_network(k=4, scope="all-time")
    print(f"live network: {len(live)} edges; "
          f"all-time (live + cold tier): {len(alltime)} edges")
    assert len(alltime) > len(live), "cold tier must widen the network"

    # -- save: one atomic, checksummed, versioned snapshot --------------
    final = idx.save(snap_dir)
    blobs = json.load(open(os.path.join(final, "manifest.json")))["blobs"]
    print(f"saved -> {final} ({len(blobs)} blobs, sha256-verified on load)")

    # -- restore IN A FRESH PROCESS and compare vs this one -------------
    code = (
        "import json, sys\n"
        "from repro_torch.api import CoocIndex\n"
        f"idx = CoocIndex.load({snap_dir!r}, device={device!r})\n"
        "out = {\n"
        "  'n_terms': idx.n_terms, 'live_docs': idx.live_docs,\n"
        "  'live': sorted((a, b, w) for (a, b), w\n"
        "           in idx.full_network(k=4).items()),\n"
        "  'alltime': sorted((a, b, w) for (a, b), w\n"
        "           in idx.full_network(k=4, scope='all-time').items()),\n"
        "  'seeded': sorted((a, b, w) for (a, b), w\n"
        "           in idx.network(['index']).items()),\n"
        "}\n"
        "json.dump(out, sys.stdout)\n")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = (os.path.abspath(src) + os.pathsep
                         + env.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        print(proc.stderr, file=sys.stderr)
        raise SystemExit("fresh-process restore failed")
    got = json.loads(proc.stdout)

    want = {
        "n_terms": idx.n_terms, "live_docs": idx.live_docs,
        "live": sorted((a, b, w) for (a, b), w in live.items()),
        "alltime": sorted((a, b, w) for (a, b), w in alltime.items()),
        "seeded": sorted((a, b, w) for (a, b), w
                         in idx.network(["index"]).items()),
    }
    want = json.loads(json.dumps(want))       # tuples -> lists, like `got`
    for key in want:
        assert got[key] == want[key], f"mismatch on {key}"
    print("fresh-process restore: live, all-time and seeded networks all "
          "bit-exact vs the in-memory oracle")
    print("OK")


if __name__ == "__main__":
    main()
