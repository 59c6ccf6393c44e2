"""The paper's target scenario, at service grade, on the PyTorch port: an
async multi-tenant co-occurrence serving front end under real-time load.

    PYTHONPATH=src python examples/torch_serve_realtime.py [--device cpu]

The port of ``examples/serve_realtime.py``, through ``repro_torch`` alone;
it runs on the GPU unless ``--device cpu`` is given.

Stands up a CoocServer over a CSL-scale-shaped corpus with two tenants —
"alpha" pinned to its own named scope of the shared index, "beta"
unscoped — and drives three phases:

1. a mixed-plan workload across both tenants (one engine, one compile per
   distinct executable — the bounded LRU compile cache underneath);
2. a burst far past the admission budget, showing explicit load shedding
   (typed "shed" responses, bounded queue depth) instead of unbounded
   queueing;
3. live ingest for the scoped tenant, visible to its very next query
   (the paper's "real-time and dynamic characteristics"), and invisible
   to the other tenant's scope.

Ends with the full metrics dump (per-tenant counters, p50/p99/p999,
shed/deadline-miss/eviction totals) and the string-level facade.
"""
import argparse
import asyncio

import numpy as np

from repro_torch.api import CoocIndex
from repro_torch.core import QueryContext
from repro_torch.data import synthetic_csl
from repro_torch.serve import (
    AdmissionPolicy,
    CoocServer,
    ServerConfig,
    TenantConfig,
)


async def serve_demo(device):
    vocab, n_docs = 1024, 4000
    docs = synthetic_csl(n_docs, vocab, seed=0)
    ctx = QueryContext.from_docs(docs, vocab, capacity=n_docs + 2048,
                                 device=device)
    # "alpha" owns a scope over a slice of fresh docs; "beta" sees it all
    server = CoocServer(
        ctx,
        tenants=[TenantConfig("alpha", scope="alpha-docs"),
                 TenantConfig("beta")],
        config=ServerConfig(
            depth=2, topk=8, beam=16, q_batch=8, compile_budget=4,
            policy=AdmissionPolicy(max_queue_depth=32, max_wait_ms=30000.0),
            default_deadline_ms=60000.0, linger_ms=50.0))
    await server.start()
    await server.ingest("alpha", [[1, 2, 3, 4]] * 6, max_len=8)

    df = np.bincount(np.concatenate([np.unique(d) for d in docs]),
                     minlength=vocab)
    hot = [int(t) for t in np.argsort(-df)[:24]]

    # phase 1: mixed plans, both tenants, one engine underneath
    plans = [dict(depth=2, topk=8, beam=16),
             dict(depth=1, topk=12, beam=16)]
    reqs = [server.submit("alpha" if i % 3 == 0 else "beta",
                          dict(seeds=[t], **plans[i % 2]))
            for i, t in enumerate(hot)]
    responses = await asyncio.gather(*reqs)
    ok = sum(r.ok for r in responses)
    snap = server.snapshot()
    print(f"phase 1: {ok}/{len(responses)} mixed-plan queries served  "
          f"p50 {snap.latency.p50_ms:.0f} ms  p99 {snap.latency.p99_ms:.0f} ms"
          f"  compiled executables: {snap.compiled_plans}")
    assert ok == len(responses)
    assert snap.compiled_plans <= 4              # bounded by compile_budget

    # phase 2: a burst past the admission budget -> explicit shedding.
    # 120 concurrent submits against max_queue_depth=32: the policy sheds
    # the excess with typed responses; nothing queues unboundedly.
    burst = [server.submit("beta", [t]) for t in (hot * 5)]
    burst_resp = await asyncio.gather(*burst)
    shed = [r for r in burst_resp if r.status == "shed"]
    served = [r for r in burst_resp if r.ok]
    snap = server.snapshot()
    print(f"phase 2: burst of {len(burst_resp)} -> {len(served)} served, "
          f"{len(shed)} shed ({shed[0].reason if shed else '-'}), "
          f"peak queue depth {snap.peak_queue_depth}")
    assert shed, "burst should trip admission control"
    assert snap.peak_queue_depth <= 32           # bounded by construction
    assert all(r.ok or r.status == "shed" for r in burst_resp)

    # phase 3: real-time scoped ingest — alpha sees its fresh docs on the
    # next query; beta's unscoped view is the whole index either way
    a, b = 7, 11
    before = await server.submit("alpha", [a])
    await server.ingest("alpha", [[a, b]] * 40, max_len=8)
    after = await server.submit("alpha", [a])
    key = (min(a, b), max(a, b))
    w0 = before.result.edges().get(key, 0) if before.ok else 0
    w1 = after.result.edges().get(key, 0)
    print(f"phase 3: alpha edge ({a},{b}) weight {w0} -> {w1} after "
          f"ingesting 40 scoped docs")
    assert after.ok and w1 >= w0 + 40

    print("\nmetrics dump:")
    print(server.render_metrics())
    final = server.snapshot()
    assert final.deadline_miss_total == 0
    assert final.tenants["alpha"].counters.ingested_docs == 46
    await server.stop()
    print("server drained and stopped  [ok]")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    asyncio.run(serve_demo(args.device))

    # the string-level facade: same engine machinery behind text in/out
    idx = CoocIndex.from_texts(
        ["inverted index serves real time queries",
         "co-occurrence networks from an inverted index",
         "real time ingest keeps the index fresh"],
        device=args.device, depth=2, topk=8, beam=8)
    print("\nCoocIndex over a toy text corpus:")
    for s, d, w in idx.top(["index"], limit=5):
        print(f"  {s:>14} -- {d:<14} (co-occurs in {w} docs)")
    idx.add_documents(["fresh documents arrive and the index answers"])
    assert "arrive" in idx
    print("facade ingest-then-query round trip  [ok]")


if __name__ == "__main__":
    main()
