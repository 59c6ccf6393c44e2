"""The port's span recorder (``repro_torch.tracing``) on the CPU: it keeps
spans only while a profile records, from any thread, on the profiler's
clock, in a bounded ring; and each of the program's spans is opened where
its work runs."""
import asyncio
import collections
import os
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.core import (  # noqa: E402
    FileStorage,
    QueryContext,
    materialize,
)
from repro_torch.serve import (  # noqa: E402
    CoocEngine,
    CoocServer,
    ServerConfig,
    TenantConfig,
)

#: every span the program opens; each is read by one benchmark metric
SPANS = {
    "cooc.engine.submit", "cooc.engine.prepare", "cooc.engine.resolve",
    "cooc.materialize.masks", "cooc.materialize.chunk",
    "cooc.materialize.count", "cooc.materialize.topk", "cooc.server.queue",
    "cooc.server.lane_step", "cooc.ingest.lists", "cooc.ingest.retire",
    "cooc.spill.encode", "cooc.spill.write", "cooc.ingest.scatter",
}

DOCS = [[0, 1, 2], [1, 2, 3], [2, 3, 4, 5], [0, 5, 6], [6, 7], [1, 7, 3]]


@pytest.fixture(autouse=True)
def _empty_ring():
    tracing.clear()
    yield
    tracing.clear()


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_outside_a_profile_nothing_is_kept():
    s = tracing.span("cooc.test", a=1)
    assert s is tracing.NO_SPAN
    with s:
        pass
    tracing.record("cooc.test", 1, 2)
    assert tracing.spans() == []
    assert tracing.dropped() == 0


def test_names_nesting_attrs_and_given_stamps():
    with _profile():
        assert tracing.span("cooc.unused") is not tracing.NO_SPAN
        with tracing.span("cooc.outer", r0=128):
            with tracing.span("cooc.inner"):
                torch.ones(8).sum()
        tracing.record("cooc.given", 5, 9, n=3)
    assert tracing.span("cooc.after") is tracing.NO_SPAN
    got = {s[0]: s for s in tracing.spans()}
    assert set(got) == {"cooc.outer", "cooc.inner", "cooc.given"}
    _, o0, o1, thread, attrs = got["cooc.outer"]
    _, i0, i1, _, inner_attrs = got["cooc.inner"]
    assert o0 <= i0 <= i1 <= o1
    assert attrs == {"r0": 128} and inner_attrs == {}
    assert thread == threading.get_ident()
    assert got["cooc.given"][1:3] == (5, 9)
    assert got["cooc.given"][4] == {"n": 3}
    # finished spans in the order they ended
    assert [s[0] for s in tracing.spans()] == ["cooc.inner", "cooc.outer",
                                               "cooc.given"]


def test_a_span_from_a_second_thread_is_kept():
    """The profiler's own enabled flag is thread-local; the server's lanes
    and ingests run on executor threads, so the recorder is not."""
    idents = []

    def work():
        idents.append(threading.get_ident())
        with tracing.span("cooc.worker"):
            pass
        tracing.record("cooc.worker.given", 1, 2)

    with _profile():
        t = threading.Thread(target=work)
        t.start()
        t.join()
    got = {s[0]: s[3] for s in tracing.spans()}
    assert got == {"cooc.worker": idents[0],
                   "cooc.worker.given": idents[0]}
    assert idents[0] != threading.get_ident()


def test_a_full_ring_counts_dropped_and_does_not_grow(monkeypatch):
    assert tracing.CAPACITY == 1 << 19
    monkeypatch.setattr(tracing, "_RING", collections.deque(maxlen=4))
    with _profile():
        for i in range(6):
            tracing.record("cooc.r", i, i + 1)
        with tracing.span("cooc.last"):
            pass
    got = tracing.spans()
    assert len(got) == 4
    assert tracing.dropped() == 3
    # the oldest are the ones overwritten
    assert [s[1] for s in got[:3]] == [3, 4, 5]
    assert got[3][0] == "cooc.last"
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_threads_lose_no_span(monkeypatch):
    """More threads than cores record at once into a ring they overflow:
    every span is either kept or counted in ``dropped``."""
    monkeypatch.setattr(tracing, "_RING", collections.deque(maxlen=1000))
    n_threads, each = (os.cpu_count() or 4) + 4, 400
    start = threading.Barrier(n_threads)

    def work(t):
        start.wait(timeout=30)
        for i in range(each):
            if i % 2:
                tracing.record("cooc.stress", t, i)
            else:
                with tracing.span("cooc.stress"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profile():
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(tracing.spans()) == 1000
    assert len(tracing.spans()) + tracing.dropped() == n_threads * each


def test_stamps_on_the_profilers_clock():
    """Each span lies within 1 ms of the profiler's own event for the same
    ``record_function``."""
    with _profile() as prof:
        # the first annotation of a process, and the first operator the
        # profiler records, pay its one-time set-up between its stamp and
        # ours: both fall in this span, outside the measured ones
        with tracing.span("cooc.warm"):
            torch.ones(64).cumsum(0)
        for i in range(5):
            with tracing.span(f"cooc.clock{i}"):
                torch.ones(64).cumsum(0)
    events = {e.name(): (e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("cooc.clock")}
    mine = [s for s in tracing.spans() if s[0].startswith("cooc.clock")]
    assert len(mine) == 5 and set(events) == {s[0] for s in mine}
    for name, a, b, _, _ in mine:
        ea, eb = events[name]
        assert abs(a - ea) < 1_000_000 and abs(b - eb) < 1_000_000, name
        assert ea <= a <= b <= eb, name


def _server_request(ctx):
    async def go():
        server = CoocServer(ctx, [TenantConfig("t")],
                            ServerConfig(depth=2, topk=4, beam=4,
                                         q_batch=4, method="gemm",
                                         linger_ms=0.0))
        await server.start()
        r = await server.submit("t", [1])
        await server.stop()
        return r
    return asyncio.run(go())


def test_every_span_of_the_program_is_opened(tmp_path):
    """A tiny engine step, whole network, server request and windowed
    ingest into a file cold store, under the profiler: each of the
    program's spans appears, and no other."""
    ctx = QueryContext.from_docs(DOCS, 8, device="cpu")
    window = QueryContext.from_docs([], 8, window=4, device="cpu",
                                    cold_store=FileStorage(tmp_path))
    with _profile():
        eng = CoocEngine(ctx, device="cpu", depth=2, topk=4, beam=4,
                         q_batch=2, method="gemm")
        fut = eng.submit([1, 2])
        eng.step()
        assert fut.done()
        net = materialize(ctx, k=4, method="pallas", use_cache=False)
        assert int(net.valid.sum()) > 0
        assert _server_request(ctx).status == "ok"
        window.ingest_docs(DOCS[:3])
        window.ingest_docs(DOCS[3:])          # evicts and spills the first
    assert window.cold_blocks() == 1
    names = collections.Counter(s[0] for s in tracing.spans())
    assert set(names) == SPANS
    assert names["cooc.spill.write"] == 1
    assert names["cooc.server.queue"] == 1
    lane = [s for s in tracing.spans() if s[0] == "cooc.server.lane_step"]
    assert lane[0][4] == {"n": 1}
    masks = [s[4]["r0"] for s in tracing.spans()
             if s[0] == "cooc.materialize.masks"]
    assert masks == sorted(masks) and masks[0] == 0


def test_an_expired_request_closes_its_queue_span():
    ctx = QueryContext.from_docs(DOCS, 8, device="cpu")

    async def go():
        server = CoocServer(ctx, [TenantConfig("t")],
                            ServerConfig(depth=2, topk=4, beam=4,
                                         q_batch=4, method="gemm"))
        await server.start()
        r = await server.submit("t", [1], deadline_ms=0.0)
        await server.stop()
        return r

    with _profile():
        resp = asyncio.run(go())
    assert (resp.status, resp.reason) == ("deadline_miss",
                                          "expired_in_queue")
    names = collections.Counter(s[0] for s in tracing.spans())
    assert names == {"cooc.server.queue": 1}


def test_the_program_keeps_nothing_outside_a_profile(tmp_path):
    ctx = QueryContext.from_docs(DOCS, 8, device="cpu")
    eng = CoocEngine(ctx, device="cpu", depth=2, topk=4, beam=4, q_batch=2,
                     method="gemm")
    eng.submit([1])
    eng.step()
    materialize(ctx, k=4, method="pallas", use_cache=False)
    assert _server_request(ctx).status == "ok"
    window = QueryContext.from_docs([], 8, window=4, device="cpu",
                                    cold_store=FileStorage(tmp_path))
    window.ingest_docs(DOCS[:3])
    window.ingest_docs(DOCS[3:])
    assert tracing.spans() == []
