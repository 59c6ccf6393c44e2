"""The port's serving tier against the JAX reference, on the CPU.

Admission, the step-time model and the metrics layer are host code copied
from ``repro.serve``: the same seeded sequences go through both packages'
classes and must give identical decisions, counters, floats, snapshots and
rendered text.  The server is ``tests/test_serving.py::TestCoocServer``
mirrored on the port's ``CoocServer`` with ``device="cpu"``; every served
network equals the reference's ``construct`` on a JAX context built from
the same docs (plain, scoped, dedicated-context and after-ingest
requests).  Warm start crosses packages both ways: a snapshot saved by
one package and served by the other's ``CoocServer.from_snapshot``.

Async paths run through ``asyncio.run`` inside sync test functions.
"""
import asyncio
import dataclasses
import inspect
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402,F401

import repro.core as J  # noqa: E402
import repro.serve as JS  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.serve as TS  # noqa: E402
from repro.data import synthetic_csl  # noqa: E402
from repro.serve import metrics as j_metrics  # noqa: E402
from repro_torch.serve import metrics as t_metrics  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionPolicy,
    CoocServer,
    ServerConfig,
    TenantConfig,
)


def _same_net(got, want, msg=""):
    for f in ("src", "dst", "weight", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{msg}/{f}")


# ---------------------------------------------------------------------------
# admission and the step-time model
# ---------------------------------------------------------------------------


def _decision(d):
    return (d.admitted, d.reason, d.est_wait_ms, bool(d))


@pytest.mark.parametrize("seed", range(6))
def test_admission_decisions_match_reference(seed):
    rng = np.random.default_rng(seed)
    depth = int(rng.integers(1, 20))
    wait = None if seed % 3 == 0 else float(rng.uniform(1.0, 500.0))
    ctls = [pkg.AdmissionController(pkg.AdmissionPolicy(
        max_queue_depth=depth, max_wait_ms=wait)) for pkg in (TS, JS)]
    for _ in range(400):
        q = int(rng.integers(0, depth + 4))
        est = float(rng.choice([0.0, rng.uniform(0, 800.0)]))
        got, want = (_decision(c.decide(queue_depth=q, est_wait_ms=est))
                     for c in ctls)
        assert got == want
        assert ctls[0].counters() == ctls[1].counters()
    assert ctls[0].shed_queue_full > 0
    if wait is not None:
        assert ctls[0].shed_est_wait > 0


@pytest.mark.parametrize("kwargs", [dict(max_queue_depth=0),
                                    dict(max_queue_depth=-3),
                                    dict(max_wait_ms=0.0),
                                    dict(max_wait_ms=-1.0)])
def test_policy_validation_matches_reference(kwargs):
    msgs = []
    for pkg in (TS, JS):
        with pytest.raises(ValueError) as e:
            pkg.AdmissionPolicy(**kwargs)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert TS.AdmissionPolicy() == TS.AdmissionPolicy(64, None)


@pytest.mark.parametrize("seed", range(6))
def test_step_time_model_and_wait_estimate_match_reference(seed):
    """Observations, evictions (``forget``) and predictions over a few
    keys, and ``estimate_wait_ms`` over random queues with and without a
    step in flight: identical floats."""
    rng = np.random.default_rng(100 + seed)
    window = int(rng.integers(1, 6))
    cold = float(rng.uniform(100.0, 3000.0))
    models = [pkg.StepTimeModel(window=window, cold_ms=cold)
              for pkg in (TS, JS)]
    keys = [("a", 1), ("b", 2), ("c", 3), ("d", 4)]
    for _ in range(300):
        op = rng.integers(0, 4)
        key = keys[int(rng.integers(0, len(keys)))]
        if op == 0:
            ms = float(rng.exponential(20.0))
            for m in models:
                m.observe(key, ms)
        elif op == 1 and rng.random() < 0.3:
            for m in models:
                m.forget(key)
        pending = [keys[int(i)] for i in
                   rng.integers(0, len(keys), int(rng.integers(0, 30)))]
        inflight = (None if rng.random() < 0.4
                    else keys[int(rng.integers(0, len(keys)))])
        kw = dict(q_batch=int(rng.integers(0, 9)), inflight_key=inflight,
                  inflight_elapsed_ms=float(rng.uniform(0, 100.0)))
        got, want = (pkg.estimate_wait_ms(iter(pending), m, **kw)
                     for pkg, m in zip((TS, JS), models))
        assert got == want
        for k in keys:
            assert models[0].predict(k) == models[1].predict(k)
            assert models[0].seen(k) == models[1].seen(k)
    with pytest.raises(ValueError, match="window"):
        TS.StepTimeModel(window=0)


def test_admission_reference_cases_on_the_port():
    """``tests/test_serving.py::TestAdmission``'s worked numbers."""
    ctl = TS.AdmissionController(AdmissionPolicy(max_queue_depth=2))
    assert ctl.decide(queue_depth=0) and ctl.decide(queue_depth=1)
    d = ctl.decide(queue_depth=2)
    assert not d and d.reason == "queue_full"
    assert ctl.counters() == (2, 1, 1, 0)
    m = TS.StepTimeModel(window=3, cold_ms=5000.0)
    assert m.predict("k") == 5000.0
    for ms in (10.0, 20.0, 30.0, 40.0):
        m.observe("k", ms)
    assert m.predict("k") == pytest.approx(30.0)
    m.forget("k")
    assert m.predict("k") == 5000.0
    m = TS.StepTimeModel(cold_ms=1000.0)
    assert TS.estimate_wait_ms([], m, q_batch=4, inflight_key="c",
                               inflight_elapsed_ms=900.0) == 1000.0
    m.observe("c", 100.0)
    assert TS.estimate_wait_ms([], m, q_batch=4, inflight_key="c",
                               inflight_elapsed_ms=40.0) == 60.0


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_server_metrics_snapshot_and_render_match_reference(seed):
    rng = np.random.default_rng(200 + seed)
    window = int(rng.integers(1, 12))
    ms = [pkg.ServerMetrics(window=window) for pkg in (t_metrics, j_metrics)]
    tenants = ["alpha", "beta", "gamma"][:int(rng.integers(1, 4))]
    fields = [f.name for f in dataclasses.fields(TS.TenantCounters)]
    for step in range(300):
        op = rng.integers(0, 3)
        name = tenants[int(rng.integers(0, len(tenants)))]
        if op == 0:
            field = fields[int(rng.integers(0, len(fields)))]
            n = int(rng.integers(0, 4))
            for m in ms:
                setattr(m.tenant(name), field,
                        getattr(m.tenant(name), field) + n)
        elif op == 1:
            v = float(rng.choice([0.0, rng.lognormal(2.0, 1.5)]))
            for m in ms:
                m.observe_latency(name, v)
        else:
            d = int(rng.integers(0, 100))
            for m in ms:
                m.note_queue_depth(d)
        if step % 25 == 0:
            kw = dict(compiled_plans=int(rng.integers(0, 9)),
                      plan_evictions=int(rng.integers(0, 9)))
            got, want = (m.snapshot(**kw) for m in ms)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.shed_rate == want.shed_rate
            assert got.deadline_miss_rate == want.deadline_miss_rate
            assert ms[0].render(got) == ms[1].render(want)
            assert ms[0].render(**kw) == ms[1].render(**kw)


def test_histogram_and_summary_match_reference():
    rng = np.random.default_rng(7)
    hs = [pkg.LatencyHistogram(window=5) for pkg in (t_metrics, j_metrics)]
    for v in rng.exponential(10.0, 40):
        for h in hs:
            h.observe(v)
        assert len(hs[0]) == len(hs[1]) <= 5
        assert (dataclasses.asdict(hs[0].summary())
                == dataclasses.asdict(hs[1].summary()))
    xs = rng.exponential(5.0, 17).tolist()
    assert (dataclasses.asdict(t_metrics.QuantileSummary.of(xs, window=3))
            == dataclasses.asdict(j_metrics.QuantileSummary.of(xs, window=3)))
    assert t_metrics.QuantileSummary.of([]) == t_metrics.QuantileSummary(
        0, 0.0, 0.0, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="window"):
        t_metrics.LatencyHistogram(window=0)


def test_snapshot_counters_are_frozen_copies():
    m = TS.ServerMetrics()
    m.tenant("a").served += 1
    snap = m.snapshot()
    m.tenant("a").served += 10
    assert snap.tenants["a"].counters.served == 1


# ---------------------------------------------------------------------------
# the public surface
# ---------------------------------------------------------------------------


def _public(obj):
    return {n for n in dir(obj) if not n.startswith("_")}


def test_serving_exports_match_reference():
    assert _public(TS) == _public(JS)


SURFACE = ("CoocServer", "ServerConfig", "TenantConfig", "ServeResponse",
           "MetricsSnapshot", "TenantCounters", "AdmissionPolicy",
           "AdmissionDecision", "AdmissionController", "StepTimeModel",
           "ServerMetrics", "LatencyHistogram", "QuantileSummary",
           "CoocRequest", "CoocEngine", "EngineStats", "Request")


@pytest.mark.parametrize("name", SURFACE)
def test_class_surface_matches_reference(name):
    """Public attributes, dataclass fields with their defaults, and the
    parameter names of every public method."""
    t_cls, j_cls = getattr(TS, name), getattr(JS, name)
    assert _public(t_cls) == _public(j_cls)
    if dataclasses.is_dataclass(j_cls):
        def spec(cls):
            return [(f.name, f.default if f.default is not dataclasses.MISSING
                     else None) for f in dataclasses.fields(cls)]
        t_spec, j_spec = spec(t_cls), spec(j_cls)
        assert [n for n, _ in t_spec] == [n for n, _ in j_spec]
        for (n, td), (_, jd) in zip(t_spec, j_spec):
            if dataclasses.is_dataclass(jd):
                assert dataclasses.asdict(td) == dataclasses.asdict(jd), n
            else:
                assert td == jd, n
    for attr in _public(j_cls) | {"__init__"}:
        j_fn = getattr(j_cls, attr)
        if not callable(j_fn) or inspect.isclass(j_fn):
            continue
        t_params = list(inspect.signature(getattr(t_cls, attr)).parameters)
        j_params = list(inspect.signature(j_fn).parameters)
        if (name, attr) == ("CoocServer", "from_snapshot"):
            t_params.remove("device")        # the port's entry points pick
        if (name, attr) == ("CoocEngine", "__init__"):
            t_params.remove("device")        # their device
        assert t_params == j_params, attr


def test_server_instance_surface_matches_reference():
    docs = synthetic_csl(40, 16, seed=1)
    servers = [pkg.CoocServer(ctx, tenants=[pkg.TenantConfig("t")])
               for pkg, ctx in (
                   (TS, T.QueryContext.from_docs(docs, 16, device="cpu")),
                   (JS, J.QueryContext.from_docs(docs, 16)))]
    assert _public(vars(servers[0])) == _public(vars(servers[1]))
    assert ServerConfig().method == "gemm"
    assert (dataclasses.asdict(ServerConfig())
            == dataclasses.asdict(JS.ServerConfig()))


# ---------------------------------------------------------------------------
# the server, mirrored from tests/test_serving.py::TestCoocServer
# ---------------------------------------------------------------------------


def _docs(n_docs=120, vocab=32, seed=7):
    return synthetic_csl(n_docs, vocab, seed=seed)


def _pair(docs, vocab=32, **kw):
    """The same docs in a port context (on the CPU) and a JAX one."""
    return (T.QueryContext.from_docs(docs, vocab, device="cpu", **kw),
            J.QueryContext.from_docs(docs, vocab, **kw))


def _server(ctx, tenants, **cfg_kw):
    cfg = dict(depth=1, topk=4, beam=8, q_batch=4, compile_budget=4,
               default_deadline_ms=120000.0, linger_ms=5.0)
    cfg.update(cfg_kw)
    return CoocServer(ctx, tenants=tenants, config=ServerConfig(**cfg))


def _want(jctx, seeds, depth=1, topk=4, beam=8, **kw):
    return J.construct(jctx, J.QuerySpec(seeds=tuple(seeds), depth=depth,
                                         topk=topk, beam=beam, **kw)).network


class TestCoocServer:
    def test_served_result_matches_construct(self):
        tctx, jctx = _pair(_docs())

        async def go():
            server = _server(tctx, [TenantConfig("t")])
            await server.start()
            resp = await server.submit("t", [3])
            await server.stop()
            return resp

        resp = asyncio.run(go())
        assert resp.ok and resp.latency_ms > 0
        assert resp.result.epoch == tctx.epoch
        _same_net(resp.result.network, _want(jctx, [3]))

    def test_lane_engine_lives_on_the_context_device(self):
        tctx, _ = _pair(_docs())
        server = _server(tctx, [TenantConfig("t")])
        lane = server._lanes["shared"]
        assert lane.engine.ctx is tctx
        assert server.ctx.device == torch.device("cpu")

    def test_concurrent_submits_batch_together(self):
        tctx, jctx = _pair(_docs())

        async def go():
            server = _server(tctx, [TenantConfig("t")], linger_ms=200.0)
            await server.start()
            await server.submit("t", [1])
            resps = await asyncio.gather(
                *[server.submit("t", [s]) for s in (2, 3, 4, 5)])
            await server.stop()
            return resps

        resps = asyncio.run(go())
        assert all(r.ok for r in resps)
        assert max(r.result.batch_occupancy for r in resps) >= 2
        for s, r in zip((2, 3, 4, 5), resps):
            _same_net(r.result.network, _want(jctx, [s]), f"seed {s}")

    def test_burst_sheds_with_bounded_queue(self):
        tctx, jctx = _pair(_docs())

        async def go():
            server = _server(tctx, [TenantConfig("t")],
                             policy=AdmissionPolicy(max_queue_depth=3))
            await server.start()
            await server.submit("t", [1])
            seeds = [s % 8 + 1 for s in range(24)]
            resps = await asyncio.gather(
                *[server.submit("t", [s]) for s in seeds])
            snap = server.snapshot()
            await server.stop()
            return seeds, resps, snap

        seeds, resps, snap = asyncio.run(go())
        shed = [r for r in resps if r.status == "shed"]
        assert shed and all(r.reason == "queue_full" for r in shed)
        assert all(r.result is None for r in shed)
        assert snap.peak_queue_depth <= 3
        assert snap.shed_total == len(shed)
        assert all(r.ok or r.status == "shed" for r in resps)
        for s, r in zip(seeds, resps):
            if r.ok:
                _same_net(r.result.network, _want(jctx, [s]), f"seed {s}")

    def test_expired_in_queue_resolves_as_deadline_miss(self):
        tctx, jctx = _pair(_docs())

        async def go():
            server = _server(tctx, [TenantConfig("t")])
            await server.start()
            await server.submit("t", [1])
            first = asyncio.create_task(server.submit("t", [2]))
            doomed = asyncio.create_task(
                server.submit("t", [3], deadline_ms=0.000001))
            r1, r2 = await asyncio.gather(first, doomed)
            snap = server.snapshot()
            await server.stop()
            return r1, r2, snap

        r1, r2, snap = asyncio.run(go())
        assert r1.ok
        _same_net(r1.result.network, _want(jctx, [2]))
        assert r2.status == "deadline_miss"
        assert snap.deadline_miss_total >= 1

    def test_tenant_scope_isolation(self):
        tctx, jctx = _pair(_docs(), capacity=512)
        for ctx in (tctx, jctx):
            ctx.ingest_docs([[1, 2]] * 5, max_len=4, scope="mine")
            ctx.ingest_docs([[1, 3]] * 7, max_len=4, scope="theirs")

        async def go():
            server = _server(tctx, [TenantConfig("a", scope="mine"),
                                    TenantConfig("b")])
            await server.start()
            scoped = await server.submit("a", [1])
            forbidden = await server.submit(
                "a", dict(seeds=[1], scope="theirs"))
            unscoped = await server.submit("b", [1])
            await server.stop()
            return scoped, forbidden, unscoped

        scoped, forbidden, unscoped = asyncio.run(go())
        assert scoped.ok
        _same_net(scoped.result.network, _want(jctx, [1], scope="mine"))
        assert scoped.result.edges()[(1, 2)] == 5
        assert (1, 3) not in scoped.result.edges()
        assert forbidden.status == "error"
        assert "forbidden_scope" in forbidden.reason
        assert forbidden.result is None
        _same_net(unscoped.result.network, _want(jctx, [1]))
        assert unscoped.result.edges()[(1, 3)] >= 7

    def test_dedicated_context_tenant_is_isolated(self):
        shared, jshared = _pair(_docs(), capacity=256)
        own, jown = _pair([[5, 6]] * 4, capacity=256)

        async def go():
            server = _server(shared, [TenantConfig("pub"),
                                      TenantConfig("vip", ctx=own)])
            await server.start()
            vip = await server.submit("vip", [5])
            await server.ingest("vip", [[5, 7]] * 9, max_len=4)
            vip2 = await server.submit("vip", [5])
            pub = await server.submit("pub", [5])
            await server.stop()
            return vip, vip2, pub

        vip, vip2, pub = asyncio.run(go())
        assert vip.result.edges() == {(5, 6): 4}
        _same_net(vip.result.network, _want(jown, [5]), "vip")
        jown.ingest_docs([[5, 7]] * 9, max_len=4)
        assert vip2.result.edges()[(5, 7)] == 9
        assert vip2.result.epoch == own.epoch
        _same_net(vip2.result.network, _want(jown, [5]), "vip after ingest")
        assert (5, 6) not in pub.result.edges()
        _same_net(pub.result.network, _want(jshared, [5]), "pub")

    def test_unknown_tenant_and_bad_request(self):
        tctx, _ = _pair(_docs())

        async def go():
            server = _server(tctx, [TenantConfig("t")])
            await server.start()
            with pytest.raises(KeyError, match="unknown tenant"):
                await server.submit("ghost", [1])
            bad = await server.submit("t", {"seeds": [1], "depht": 2})
            await server.stop()
            with pytest.raises(RuntimeError, match="not running"):
                await server.submit("t", [1])
            return bad

        bad = asyncio.run(go())
        assert bad.status == "error" and "bad_request" in bad.reason

    def test_stop_without_drain_flushes_futures(self):
        tctx, jctx = _pair(_docs())

        async def go():
            server = _server(tctx, [TenantConfig("t")])
            await server.start()
            await server.submit("t", [1])
            seeds = [s % 8 + 1 for s in range(12)]
            pending = [asyncio.create_task(server.submit("t", [s]))
                       for s in seeds]
            await asyncio.sleep(0)
            await server.stop(drain=False)
            return seeds, await asyncio.gather(*pending)

        seeds, resps = asyncio.run(go())
        assert all(r.status in ("ok", "error", "deadline_miss")
                   for r in resps)
        assert any(r.reason == "server_shutdown" for r in resps)
        for s, r in zip(seeds, resps):
            if r.result is not None:
                _same_net(r.result.network, _want(jctx, [s]), f"seed {s}")

    def test_slow_step_does_not_stall_other_tenants_admission(self):
        SLOW_S = 1.2
        slow_ctx, _ = _pair(_docs(seed=7))
        fast_ctx, j_fast = _pair(_docs(seed=11))

        async def go():
            server = _server(fast_ctx, [TenantConfig("slow", ctx=slow_ctx),
                                        TenantConfig("fast")])
            await server.start()
            assert (await server.submit("slow", [1])).ok
            assert (await server.submit("fast", [1])).ok
            eng = server._lanes[server._tenant_lane["slow"]].engine
            orig_drain = eng.run_until_drained

            def stalled_drain(*a, **kw):
                time.sleep(SLOW_S)               # executor thread
                return orig_drain(*a, **kw)

            eng.run_until_drained = stalled_drain
            slow_task = asyncio.create_task(server.submit("slow", [2]))
            await asyncio.sleep(0.1)
            t0 = time.monotonic()
            fast = await server.submit("fast", [2])
            fast_elapsed = time.monotonic() - t0
            slow_done_early = slow_task.done()
            slow = await slow_task
            await server.stop()
            return fast, fast_elapsed, slow, slow_done_early

        fast, fast_elapsed, slow, slow_done_early = asyncio.run(go())
        assert fast.ok and slow.ok
        assert not slow_done_early
        assert fast_elapsed < SLOW_S / 2
        _same_net(fast.result.network, _want(j_fast, [2]))

    def test_compile_budget_enforced_across_server(self):
        tctx, jctx = _pair(_docs())

        async def go():
            server = _server(tctx, [TenantConfig("t")], compile_budget=2)
            lane = server._lanes["shared"]
            await server.start()
            resps = []
            for beam in (8, 16, 24):
                r = await server.submit("t", dict(seeds=[1], beam=beam))
                assert r.ok
                resps.append(r)
            snap = server.snapshot()
            seen = [lane.model.seen(canonical) for canonical in
                    (r.result.spec.plan_key for r in resps)]
            await server.stop()
            return resps, snap, seen

        resps, snap, seen = asyncio.run(go())
        assert snap.compiled_plans <= 2
        assert snap.plan_evictions >= 1
        # the evicted plan's step times were forgotten with its executor
        assert seen == [False, True, True]
        for beam, r in zip((8, 16, 24), resps):
            _same_net(r.result.network, _want(jctx, [1], beam=beam),
                      f"beam {beam}")

    def test_metrics_accumulate_across_phases(self):
        tctx, jctx = _pair(_docs(), capacity=512)

        async def go():
            server = _server(tctx, [TenantConfig("t", scope="s")])
            await server.start()
            await server.ingest("t", [[1, 2]] * 3, max_len=4)
            resp = await server.submit("t", [1])
            text = server.render_metrics()
            snap = server.snapshot()
            depth = server.queue_depth(), server.queue_depth("t")
            await server.stop()
            return resp, text, snap, depth

        resp, text, snap, depth = asyncio.run(go())
        assert snap.tenants["t"].counters.ingested_docs == 3
        assert snap.served_total == 1
        assert snap.latency.n == 1
        assert depth == (0, 0)
        assert 'cooc_serve_ingested_docs_total{tenant="t"} 3' in text
        jctx.ingest_docs([[1, 2]] * 3, max_len=4, scope="s")
        _same_net(resp.result.network, _want(jctx, [1], scope="s"))


def test_tenant_config_validation_matches_reference():
    tctx, jctx = _pair(_docs(40, 16))
    cases = [dict(name=""), dict(name="x", scope="s", ctx="CTX"),
             dict(name="x", policy="POLICY")]
    for kw in cases:
        msgs = []
        for pkg, ctx in ((TS, tctx), (JS, jctx)):
            args = {k: (ctx if v == "CTX" else pkg.AdmissionPolicy()
                        if v == "POLICY" else v) for k, v in kw.items()}
            with pytest.raises(ValueError) as e:
                pkg.TenantConfig(**args)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    server = _server(tctx, [TenantConfig("t")])
    with pytest.raises(ValueError, match="already registered"):
        server.add_tenant(TenantConfig("t"))


# ---------------------------------------------------------------------------
# warm start from a snapshot, across packages
# ---------------------------------------------------------------------------

WS_DOCS = [[0, 1, 2], [1, 2, 3], [2, 3, 4], [0, 4, 5], [5, 6], [0, 6, 7],
           [7, 8, 9], [1, 8], [3, 9, 10], [2, 10, 11]]
WS_VOCAB = 12


@pytest.mark.parametrize("direction", ["ref-to-port", "port-to-ref"])
def test_from_snapshot_serves_like_the_other_package(tmp_path, direction):
    """A scope-tagged snapshot saved by one package, served by the other's
    ``CoocServer.from_snapshot``: plain and scoped requests equal the
    saving package's engine."""
    tctx, jctx = (T.QueryContext.from_docs(WS_DOCS, WS_VOCAB, device="cpu"),
                  J.QueryContext.from_docs(WS_DOCS, WS_VOCAB))
    for ctx in (tctx, jctx):
        ctx.tag_scope("t0", list(range(5)))
    path = str(tmp_path / "snap")
    spec = dict(seeds=(0, 2), depth=2, topk=4, beam=8)
    if direction == "ref-to-port":
        J.save_context(jctx, path)
        want = [JS.CoocEngine(jctx).submit(J.QuerySpec(**spec, scope=s))
                .result().network for s in (None, "t0")]
        pkg, kw = TS, dict(device="cpu")
    else:
        T.save_context(tctx, path)
        eng = TS.CoocEngine(tctx, device="cpu")
        want = [eng.submit(T.QuerySpec(**spec, scope=s)).result().network
                for s in (None, "t0")]
        pkg, kw = JS, {}
    cfg = pkg.ServerConfig(depth=2, topk=4, beam=8)

    async def run():
        srv = pkg.CoocServer.from_snapshot(
            path, tenants=[pkg.TenantConfig("acme"),
                           pkg.TenantConfig("scoped", scope="t0")],
            config=cfg, **kw)
        assert srv.ctx.scope_names() == ("t0",)
        await srv.start()
        try:
            r = await srv.submit("acme", dict(spec))
            rs = await srv.submit("scoped", dict(spec))
        finally:
            await srv.stop()
        return srv, r, rs

    srv, r, rs = asyncio.run(run())
    assert r.ok and rs.ok
    assert rs.result.spec.scope == "t0"
    _same_net(r.result.network, want[0], f"{direction}/plain")
    _same_net(rs.result.network, want[1], f"{direction}/scoped")
    if direction == "ref-to-port":
        assert srv.ctx.device == torch.device("cpu")
        assert isinstance(srv.ctx, T.QueryContext)


def test_from_snapshot_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    path = str(tmp_path / "snap")
    T.save_context(T.QueryContext.from_docs(WS_DOCS, WS_VOCAB, device="cpu"),
                   path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CoocServer.from_snapshot(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CoocServer.from_snapshot(str(tmp_path / "nothing-here"))
    with pytest.raises(TypeError, match="CoocMesh"):
        CoocServer.from_snapshot(path, device="cpu", mesh=object())
    srv = CoocServer.from_snapshot(path, device="cpu")
    assert srv.ctx.n_docs == len(WS_DOCS)
