"""Streaming window on the PyTorch port: a live index under continuous
ingest, bounded memory, time-bucket and source-tag scoped queries.

    PYTHONPATH=src python examples/torch_streaming_window.py [--device cpu]

The port of ``examples/streaming_window.py``, through ``repro_torch``
alone; it runs on the GPU unless ``--device cpu`` is given.

1. open a CoocIndex with a sliding window — at most ``WINDOW`` live docs,
   oldest ingest blocks evicted as new ones arrive, capacity pinned,
2. stream day-batches of documents through it (far more than the window),
3. query the full window vs a trailing time bucket (``scope="3d"``) vs a
   source tag (``scope="press"``) — each scope is one bitmap AND on device,
4. verify the memory bound and that evicted days really left the counts.
"""
import argparse

import numpy as np

from repro_torch.api import CoocIndex

WINDOW = 64
DAY = 86400.0

# a tiny rotating topic mix: each "day" leans on one topic
TOPICS = {
    "markets": "markets inflation rates bonds equities markets inflation",
    "climate": "climate emissions warming policy climate emissions energy",
    "chips": "chips fabs lithography silicon chips yields wafers",
}


def day_texts(day: int, rng: np.random.Generator, n: int = 16):
    topic = list(TOPICS)[day % len(TOPICS)]
    base = TOPICS[topic].split()
    texts = []
    for _ in range(n):
        words = rng.choice(base, size=5, replace=True).tolist()
        texts.append(" ".join(words + ["daily", "report"]))
    return topic, texts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    idx = CoocIndex(device=args.device, window=WINDOW, depth=1, topk=8,
                    beam=8, q_batch=4)
    cap0 = idx.ctx.index.capacity
    print(f"window={WINDOW} docs -> capacity pinned at {cap0} slots")

    for day in range(10):                     # 160 docs through a 64-window
        topic, texts = day_texts(day, rng)
        source = "press" if day % 2 == 0 else "wire"
        idx.add_documents(texts, timestamp=day * DAY, source=source)
        assert idx.ctx.index.capacity == cap0, "capacity must never grow"
        print(f"day {day}: +{len(texts)} {topic:>8} docs ({source})  "
              f"live={idx.live_docs:>3}  evicted so far="
              f"{idx.ctx.evicted_docs_total}")

    assert idx.live_docs <= WINDOW
    now = 9 * DAY + 1.0

    full = idx.top(["report"], limit=4)
    print("\nwhole window around 'report':")
    for a, b, w in full:
        print(f"  {a:>10} -- {b:<10} ({w} docs)")

    recent = idx.top(["report"], limit=4, scope="3d", now=now)
    print("last 3 days only (scope='3d'):")
    for a, b, w in recent:
        print(f"  {a:>10} -- {b:<10} ({w} docs)")

    press = idx.top(["report"], limit=4, scope="press")
    print("press-tagged docs only (scope='press'):")
    for a, b, w in press:
        print(f"  {a:>10} -- {b:<10} ({w} docs)")

    # the window really evicts: day-0..5 docs are gone, so the live count
    # for any pair can never exceed the window
    net = idx.network(["report"])
    assert all(w <= WINDOW for w in net.values())
    # a 3-day bucket can only see 3 ingest days' worth of docs
    net3 = idx.network(["report"], scope="3d", now=now)
    assert all(w <= 3 * 16 for w in net3.values())
    print("\nbounded memory + scoped counts verified  [ok]")


if __name__ == "__main__":
    main()
