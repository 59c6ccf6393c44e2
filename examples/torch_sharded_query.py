"""Device-mesh sharded queries through the string-level facade, on the
PyTorch port.

    PYTHONPATH=src python examples/torch_sharded_query.py [--device cpu]

The port of ``examples/sharded_query.py``, through ``repro_torch`` alone.
Where the reference forces an 8-device CPU host, the port's mesh repeats
one device 8 times (``["cuda"] * 8`` on the GPU, the default, or
``["cpu"] * 8`` with ``--device cpu``; a mesh may repeat a device).  It
builds one single-device CoocIndex and one term-sharded over the 8
shards, and shows that ingest, BFS queries, scoped queries and
full-network materialization answer IDENTICALLY: the sharded engine is a
bit-exact drop-in that executes across the mesh.
"""
import argparse

from repro_torch.api import CoocIndex

TEXTS = [
    "the inverted index maps every term to its posting documents",
    "a co-occurrence network links terms that share documents",
    "real time construction keeps the network fresh under ingest",
    "term partitioned postings scale the index across devices",
    "each device counts against its local postings shard",
    "partial counts merge across the device mesh",
    "the merged network is bit exact against one device",
    "queries stream through the engine in micro batches",
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--shards", type=int, default=8,
                    help="mesh shards, each on --device")
    args = ap.parse_args(argv)

    devices = [args.device] * args.shards
    print(f"host devices: {len(devices)}")
    plain = CoocIndex.from_texts(TEXTS, device=args.device, depth=2, topk=8,
                                 beam=16)
    sharded = CoocIndex(device=args.device, depth=2, topk=8, beam=16,
                        devices=devices)              # term-sharded mesh
    sharded.add_documents(TEXTS)
    print(f"sharded mesh: {dict(sharded.mesh.shape)}")

    # live ingest stays bit-exact: both see the new doc immediately
    fresh = ["fresh documents join the postings shards immediately"]
    plain.add_documents(fresh, source="fresh")
    sharded.add_documents(fresh, source="fresh")

    for seeds in (["index"], ["network", "device"]):
        a = plain.network(seeds)
        b = sharded.network(seeds)
        assert a == b, (seeds, a, b)
        top = sorted(a.items(), key=lambda kv: -kv[1])[:3]
        print(f"query {seeds}: {len(a)} edges, top {top}   [identical]")

    a = plain.network(["documents"], scope="fresh")
    b = sharded.network(["documents"], scope="fresh")
    assert a == b
    print(f"scoped query ('fresh'): {b}   [identical]")

    full_a = plain.full_network(k=4)
    full_b = sharded.full_network(k=4)
    assert full_a == full_b
    st = sharded.network_stats(k=4)
    print(f"full network: {st.n_nodes} nodes, {st.n_edges} edges, "
          f"density {st.density:.3f}   [identical]")
    print("sharded == single-device, bit for bit  [ok]")


if __name__ == "__main__":
    main()
