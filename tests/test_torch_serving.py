"""PyTorch port: the solver service (``repro_torch.serving``) and the
span-trace export (``repro_torch.obs.export``), against the reference's
``repro.serving``.

The cases of ``tests/test_serving.py`` run against the port on a CPU
operator (the 16 x 16 grid, exponential kernel l = 0.1, leaf 16,
Chebyshev 4: the reference's operator carried to the port bitwise), with
``backend="torch"`` and ``device="cpu"``: the cache (LRU byte budget,
single flight, ``lookup_loosest``), admission backpressure, the panel,
the serve loop and its fault drill, the threaded front-end and the guard
propagation.  Parity with the reference on the same load, fault plan and
``dispatch_cost``: the same completion statuses and finish times, the
same dispatches (virtual start, active columns, breaker state -- so the
same batches in admission order), the same counters and breaker
transitions, iterations within 1 and ``x`` within 1e-4.  Also: the span
trace parses and holds the serve spans; an ``OperatorKey`` with a
distributed ``comm`` is refused without a ``comm=``; on the card, a
second service on the same cache entry captures nothing.

JAX is imported inside fixtures only.
"""
import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import structure as ts
from repro_torch.runtime.fault import CircuitBreaker, StragglerMonitor
from repro_torch.serving import (OperatorCache, OperatorKey, PanelState,
                                 PoissonLoad, QueueFull, RequestQueue,
                                 ServiceFaultPlan, SolveRequest,
                                 SolverService, ThreadedSolverService,
                                 geometry_digest)

torch.set_num_threads(2)

DEVICE = dict(device="cpu", backend="torch")
N = 256
DRILL_PLAN = dict(device_loss_at={1: "device lost", 2: "device lost",
                                  9: "preempted"},
                  nan_at={6}, straggle_at={4: 0.5})


# ---------------------------------------------------------------------------
# cache

class FakeShape:
    """Stand-in with the H2Shape memory accounting the cache uses."""

    def __init__(self, scalars, n=64):
        self._scalars = scalars
        self.n = n

    def memory_lowrank(self):
        return self._scalars

    def memory_dense(self):
        return 0


def _key(tag, tol=None):
    return OperatorKey(geometry=tag, kernel=("exp", 0.1), tol=tol)


def _build(scalars):
    return lambda: (FakeShape(scalars), {"v": np.zeros(scalars)}, {})


class TestOperatorCache:
    def test_cache_aside_hit_and_miss(self):
        cache = OperatorCache(max_bytes=1 << 20)
        e1 = cache.get_or_build(_key("a"), _build(100))
        e2 = cache.get_or_build(_key("a"), _build(100))
        assert e1 is e2
        assert cache.stats()["misses"] == 1 and cache.stats()["hits"] == 1
        assert e1.nbytes == 400

    def test_lru_byte_budget_eviction(self):
        cache = OperatorCache(max_bytes=1000)
        cache.get_or_build(_key("a"), _build(100))
        cache.get_or_build(_key("b"), _build(100))
        cache.get_or_build(_key("a"), _build(100))
        cache.get_or_build(_key("c"), _build(100))
        assert _key("a") in cache and _key("c") in cache
        assert _key("b") not in cache
        assert cache.stats()["evictions"] == 1
        cache.get_or_build(_key("b"), _build(100))
        assert cache.stats()["misses"] == 4

    def test_max_entries_budget(self):
        cache = OperatorCache(max_bytes=1 << 30, max_entries=2)
        for tag in "abc":
            cache.get_or_build(_key(tag), _build(10))
        assert len(cache) == 2 and _key("a") not in cache

    def test_oversize_entry_admitted_alone(self):
        cache = OperatorCache(max_bytes=100)
        cache.get_or_build(_key("small"), _build(10))
        cache.get_or_build(_key("huge"), _build(10_000))
        assert _key("huge") in cache and _key("small") not in cache
        assert len(cache) == 1

    def test_single_flight_concurrent_misses_build_once(self):
        cache = OperatorCache()
        builds = []
        gate = threading.Event()

        def build():
            gate.wait(5.0)
            builds.append(1)
            return FakeShape(10), {}, {}

        entries = [None] * 8

        def worker(i):
            entries[i] = cache.get_or_build(_key("shared"), build)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        gate.set()
        for t in threads:
            t.join(10.0)
        assert len(builds) == 1
        assert all(e is entries[0] for e in entries)

    def test_build_failure_releases_single_flight(self):
        cache = OperatorCache()

        def bad():
            raise RuntimeError("construction failed")

        with pytest.raises(RuntimeError):
            cache.get_or_build(_key("x"), bad)
        assert cache.get_or_build(_key("x"), _build(10)).nbytes == 40

    def test_lookup_loosest_degraded_candidate(self):
        cache = OperatorCache()
        cache.get_or_build(_key("g", tol=None), _build(100))
        cache.get_or_build(_key("g", tol=1e-5), _build(80))
        cache.get_or_build(_key("g", tol=1e-3), _build(40))
        hit = cache.lookup_loosest(_key("g", tol=1e-5), max_tol=1e-2)
        assert hit is not None and hit.key.tol == 1e-3
        assert cache.lookup_loosest(_key("g", tol=1e-5),
                                    max_tol=1e-6) is None
        assert cache.lookup_loosest(_key("other", tol=1e-5),
                                    max_tol=1e-2) is None

    def test_geometry_digest_matches_reference(self):
        pytest.importorskip("jax")
        from repro.serving import geometry_digest as ref_digest
        pts = np.random.default_rng(0).random((64, 2))
        assert geometry_digest(pts) == ref_digest(pts)
        assert geometry_digest(pts.astype(np.float32)) != \
            geometry_digest(pts)


# ---------------------------------------------------------------------------
# admission + panel + load

class TestRequestQueue:
    def test_backpressure_rejects_with_retry_after(self):
        q = RequestQueue(capacity=2, drain_hint=0.1)
        r = lambda i: SolveRequest(rid=i, b=np.zeros(4), arrival=0.0)
        q.offer(r(0))
        q.offer(r(1))
        with pytest.raises(QueueFull) as ei:
            q.offer(r(2))
        assert ei.value.retry_after >= 0.1
        assert q.rejected == 1 and q.admitted == 2

    def test_take_drains_expired_separately(self):
        q = RequestQueue(capacity=8)
        live = SolveRequest(rid=0, b=np.zeros(4), arrival=0.0,
                            deadline=10.0)
        dead = SolveRequest(rid=1, b=np.zeros(4), arrival=0.0,
                            deadline=0.5)
        q.offer(dead)
        q.offer(live)
        got, expired = q.take(4, now=1.0)
        assert [r.rid for r in got] == [0]
        assert [r.rid for r in expired] == [1]
        assert len(q) == 0


class TestPanelState:
    def test_admit_evict_roundtrip(self):
        panel = PanelState(n=4, width=3, device="cpu")
        reqs = [SolveRequest(rid=i, b=np.full(4, float(i + 1), np.float32),
                             arrival=0.0) for i in range(2)]
        panel.admit(reqs)
        assert panel.occupancy == 2 and panel.free_slots() == [2]
        assert bool((panel.b[:, 0] == 1.0).all())
        assert bool((panel.b[:, 1] == 2.0).all())
        assert bool((panel.b[:, 2] == 0.0).all())
        assert panel.b.device.type == "cpu" and panel.b.shape == (4, 3)
        out = panel.evict(0)
        assert out.rid == 0
        assert panel.occupancy == 1 and bool((panel.b[:, 0] == 0.0).all())
        panel.admit([SolveRequest(rid=9, b=np.full(4, 9.0, np.float32),
                                  arrival=1.0)])
        assert panel.reqs[0].rid == 9

    def test_tightest_tol(self):
        panel = PanelState(n=4, width=3, device="cpu")
        panel.admit([SolveRequest(rid=0, b=np.zeros(4, np.float32),
                                  arrival=0.0, tol=1e-4),
                     SolveRequest(rid=1, b=np.zeros(4, np.float32),
                                  arrival=0.0, tol=1e-7)])
        assert panel.tightest_tol(1e-6) == 1e-7
        assert PanelState(n=4, width=2, device="cpu").tightest_tol(1e-6) \
            == 1e-6


@pytest.mark.parametrize("deadline", [None, 0.5])
def test_poisson_load_matches_reference(deadline):
    pytest.importorskip("jax")
    from repro.serving import PoissonLoad as RefLoad
    kw = dict(n=64, rate=50.0, n_requests=12, tol=1e-5, seed=7,
              deadline_s=deadline)
    ours, ref = PoissonLoad(**kw).requests(), RefLoad(**kw).requests()
    for a, b in zip(ours, ref):
        assert (a.rid, a.arrival, a.deadline, a.tol) == \
            (b.rid, b.arrival, b.deadline, b.tol)
        assert a.b.dtype == b.b.dtype and np.array_equal(a.b, b.b)


# ---------------------------------------------------------------------------
# the service against a real operator

@pytest.fixture(scope="module")
def operator():
    """The reference's 16 x 16 operator, its key, a build function of
    the port's bitwise copy (on the CPU) and the reference's own."""
    pytest.importorskip("jax")
    from repro.core.clustering import regular_grid_points
    from repro.core.construction import construct_h2
    from repro.core.kernels_fn import exponential_kernel
    from test_torch_structure import jax_data_to_numpy

    pts = regular_grid_points(16, 2)
    key = OperatorKey(geometry=geometry_digest(pts),
                      kernel=("exponential", 0.1), tol=None)
    rshape, rdata, _, _ = construct_h2(pts, exponential_kernel(0.1),
                                       leaf_size=16, cheb_p=4, eta=0.9)
    arrays = jax_data_to_numpy(rdata)

    def build():
        return (ts.H2Shape(**dataclasses.asdict(rshape)),
                ts.data_from_numpy(arrays, device="cpu"), {})

    def ref_build():
        return rshape, rdata, {}
    return pts, key, build, ref_build


def _drill_kw(**kw):
    out = dict(panel_width=4, restart_every=20, max_segments=20,
               queue_capacity=16, tol=1e-6, dispatch_cost=0.02,
               detect_delay=0.005, seed=0,
               breaker=CircuitBreaker(failure_threshold=2, cooldown=0.1),
               straggler=StragglerMonitor(threshold=3.0, warmup=2))
    out.update(kw)
    return out


def _drill_service(fault_plan=None, **kw):
    return SolverService(OperatorCache(), fault_plan=fault_plan,
                         **_drill_kw(**kw), **DEVICE)


def _load(n_requests=16, rate=100.0, seed=3):
    return PoissonLoad(n=N, rate=rate, n_requests=n_requests, tol=1e-6,
                       seed=seed)


def _x(c) -> np.ndarray:
    return np.asarray(c.x.cpu().numpy() if torch.is_tensor(c.x) else c.x)


class TestServeLoop:
    def test_fault_free_serves_all_to_tolerance(self, operator):
        _, key, build, _ = operator
        rep = _drill_service().serve(_load().requests(), key, build)
        m = rep.metrics
        assert m["completed"] == 16 and m["timeouts"] == 0
        assert all(c.status == "ok" for c in rep.completions.values())
        assert max(c.relres for c in rep.completions.values()) <= 1e-6
        assert m["breaker_trips"] == 0 and m["retries"] == 0

    def test_continuous_batching_coalesces(self, operator):
        _, key, build, _ = operator
        rep = _drill_service().serve(
            _load(n_requests=16, rate=1000.0).requests(), key, build)
        m = rep.metrics
        assert m["completed"] == 16
        assert m["mean_occupancy"] > 1.5
        assert m["dispatches"] < 16

    def test_deterministic_fault_drill(self, operator):
        _, key, build, _ = operator
        baseline = _drill_service().serve(_load().requests(), key, build)
        rep = _drill_service(fault_plan=ServiceFaultPlan(**DRILL_PLAN)) \
            .serve(_load().requests(), key, build)
        m = rep.metrics
        assert m["completed"] == 16 and m["timeouts"] == 0
        assert all(c.status == "ok" for c in rep.completions.values())
        for rid, c0 in baseline.completions.items():
            x0, x1 = _x(c0), _x(rep.completions[rid])
            assert np.linalg.norm(x1 - x0) / np.linalg.norm(x0) < 1e-3
        assert m["dispatch_failures"] >= 3 and m["retries"] >= 1
        assert m["degraded_dispatches"] >= 1 and m["hedges"] >= 1
        assert m["breaker_trips"] >= 1 and m["breaker_recoveries"] >= 1
        hops = [(t["from"], t["to"]) for t in m["breaker_transitions"]]
        for hop in (("closed", "open"), ("open", "half-open"),
                    ("half-open", "closed")):
            assert hop in hops

    def test_drill_is_reproducible(self, operator):
        _, key, build, _ = operator
        plan = {"device_loss_at": {1: "dl", 2: "dl"}, "nan_at": {6},
                "straggle_at": {4: 0.5}}
        reps = [_drill_service(fault_plan=ServiceFaultPlan(**plan)).serve(
            _load().requests(), key, build) for _ in range(2)]
        m0, m1 = (r.metrics for r in reps)
        for k in ("completed", "dispatches", "dispatch_failures", "retries",
                  "hedges", "degraded_dispatches", "breaker_trips",
                  "breaker_recoveries", "timeouts"):
            assert m0[k] == m1[k], k
        assert m0["breaker_transitions"] == m1["breaker_transitions"]
        for rid, c in reps[0].completions.items():
            assert np.array_equal(_x(c), _x(reps[1].completions[rid]))

    def test_nan_divergence_is_retried(self, operator):
        _, key, build, _ = operator
        rep = _drill_service(fault_plan=ServiceFaultPlan(nan_at={0})) \
            .serve(_load(n_requests=4).requests(), key, build)
        m = rep.metrics
        assert m["completed"] == 4
        assert m["dispatch_failures"] == 1 and m["retries"] == 1
        assert all(np.isfinite(_x(c)).all()
                   for c in rep.completions.values())

    def test_deadline_expiry_counts_timeouts(self, operator):
        _, key, build, _ = operator
        reqs = _load(n_requests=6).requests()
        for r in reqs[3:]:
            r.deadline = r.arrival + 1e-4
        rep = _drill_service().serve(reqs, key, build)
        m = rep.metrics
        assert m["completed"] == 3 and m["timeouts"] == 3
        assert sorted(c.rid for c in rep.completions.values()
                      if c.status == "timeout") == [3, 4, 5]

    def test_backpressure_resubmits_and_rejects(self, operator):
        _, key, build, _ = operator
        svc = _drill_service(queue_capacity=2, max_resubmits=1,
                             dispatch_cost=0.5)
        rep = svc.serve(_load(n_requests=12, rate=1000.0).requests(), key,
                        build)
        m = rep.metrics
        assert m["queue_rejections"] > 0 and m["resubmits"] > 0
        assert m["rejected"] > 0
        assert m["completed"] + m["rejected"] + m["timeouts"] == 12

    def _loose_service(self, operator):
        from repro_torch.core.compression import compress
        _, key, build, _ = operator

        def build_loose():
            shape, data, extra = build()
            cshape, cdata = compress(shape, data, tol=1e-4, backend="torch")
            return cshape, cdata, extra

        cache = OperatorCache()
        cache.get_or_build(key.loosened(1e-4), build_loose)
        svc = SolverService(
            cache, panel_width=4, restart_every=20, max_segments=20,
            tol=1e-5, dispatch_cost=0.02, seed=0, degraded="loose",
            degraded_tol=1e-3,
            breaker=CircuitBreaker(failure_threshold=1, cooldown=10.0),
            fault_plan=ServiceFaultPlan(device_loss_at={
                i: "dl" for i in range(0, 8)}), **DEVICE)
        load = PoissonLoad(n=N, rate=100.0, n_requests=4, tol=1e-5, seed=3)
        return svc.serve(load.requests(), key, build)

    def test_degraded_loose_operator_path(self, operator):
        rep = self._loose_service(operator)
        m = rep.metrics
        assert m["breaker_trips"] >= 1 and m["degraded_dispatches"] >= 1
        assert m["completed"] == 4
        for c in rep.completions.values():
            assert c.status == "ok" and np.isfinite(_x(c)).all()

    def test_degraded_completions_are_marked(self, operator):
        rep = self._loose_service(operator)
        degraded = [c for c in rep.completions.values()
                    if c.via == "degraded"]
        assert degraded
        for c in degraded:
            assert c.iters > 0 and np.isfinite(_x(c)).all()

    def test_fault_free_completions_are_primary(self, operator):
        _, key, build, _ = operator
        rep = _drill_service().serve(_load(n_requests=8).requests(), key,
                                     build)
        for c in rep.completions.values():
            assert c.via == "primary" and c.solver_status == 0
            assert c.iters > 0

    def test_span_trace_export(self, operator, tmp_path):
        from repro_torch.obs.export import write_span_trace
        _, key, build, _ = operator
        rep = _drill_service().serve(_load(n_requests=4).requests(), key,
                                     build)
        assert any(s["name"] == "serve/dispatch" for s in rep.spans)
        path = tmp_path / "serve_trace.json"
        write_span_trace(str(path), rep.spans)
        doc = json.loads(path.read_text())
        evs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        assert evs and all("ts" in e and "dur" in e for e in evs)
        assert {e["name"] for e in evs} >= {"serve/operator",
                                            "serve/dispatch"}

    def test_cache_shared_across_services(self, operator):
        _, key, build, _ = operator
        cache = OperatorCache()
        SolverService(cache, panel_width=4, dispatch_cost=0.02, seed=0,
                      **DEVICE).serve(_load(n_requests=2).requests(), key,
                                      build)

        def must_not_build():
            raise AssertionError("second service rebuilt a cached operator")
        rep = SolverService(cache, panel_width=4, dispatch_cost=0.02,
                            seed=0, **DEVICE).serve(
            _load(n_requests=2).requests(), key, must_not_build)
        assert rep.metrics["completed"] == 2
        assert cache.stats()["misses"] == 1

    @pytest.mark.parametrize("comm", ["halo-plan", "allgather"])
    def test_distributed_key_is_refused(self, operator, comm):
        """A distributed key needs each rank's ``comm=`` (served in
        lockstep: ``tests/test_torch_serving_dist.py``, and live from
        rank 0 by the threaded front-end:
        ``tests/test_torch_threaded_dist.py``); without one, both the
        virtual loop and the threaded front-end refuse it, and neither
        builds the operator."""
        _, key, build, _ = operator
        dkey = dataclasses.replace(key, comm=comm)
        svc = _drill_service()
        with pytest.raises(NotImplementedError, match="every rank"):
            svc.serve(_load(n_requests=2).requests(), dkey, build)
        with pytest.raises(NotImplementedError, match="every rank"):
            ThreadedSolverService(svc, dkey, build)
        assert svc.cache.stats()["misses"] == 0


# ---------------------------------------------------------------------------
# parity with the reference's service

def _episode(service, operator, plan, load, ref: bool, **kw):
    from repro.runtime.fault import CircuitBreaker as RB
    from repro.runtime.fault import StragglerMonitor as RS
    from repro.serving import OperatorCache as RC
    from repro.serving import ServiceFaultPlan as RP
    from repro.serving import SolverService as RSvc
    _, key, build, ref_build = operator
    kw = _drill_kw(**kw)
    if ref:
        from repro.serving import OperatorKey as RK
        kw.update(breaker=RB(failure_threshold=2, cooldown=0.1),
                  straggler=RS(threshold=3.0, warmup=2))
        svc = RSvc(RC(), fault_plan=RP(**plan), **kw)
        return svc.serve(load.requests(), RK(**dataclasses.asdict(key)),
                         ref_build)
    svc = service(OperatorCache(), fault_plan=ServiceFaultPlan(**plan),
                  **kw, **DEVICE)
    return svc.serve(load.requests(), key, build)


COUNTERS = ("dispatches", "dispatch_failures", "retries", "hedges",
            "hedge_wins", "degraded_dispatches", "completed", "timeouts",
            "rejected", "resubmits", "unconverged", "guard_trips",
            "breaker_trips", "breaker_recoveries", "queue_rejections",
            "queue_peak_depth", "panel_width")


@pytest.mark.parametrize("case", ["fault_free", "drill", "backpressure"])
def test_service_matches_reference(operator, case):
    plan, load, kw = {
        "fault_free": ({}, _load(), {}),
        "drill": (DRILL_PLAN, _load(), {}),
        "backpressure": ({}, _load(n_requests=12, rate=1000.0),
                         dict(queue_capacity=2, max_resubmits=1,
                              dispatch_cost=0.5)),
    }[case]
    ours = _episode(SolverService, operator, plan, load, False, **kw)
    ref = _episode(None, operator, plan, load, True, **kw)
    mo, mr = ours.metrics, ref.metrics
    for k in COUNTERS:
        assert mo[k] == mr[k], (k, mo[k], mr[k])
    assert mo["makespan_s"] == pytest.approx(mr["makespan_s"], rel=1e-12)
    assert mo["mean_occupancy"] == mr["mean_occupancy"]
    assert mo["breaker_transitions"] == mr["breaker_transitions"]

    def dispatches(rep):
        return [(round(s["ts"], 3), s["args"]["active"],
                 s["args"]["breaker"]) for s in rep.spans
                if s["name"] == "serve/dispatch"]
    assert dispatches(ours) == dispatches(ref)
    assert sorted(ours.completions) == sorted(ref.completions)
    for rid, cr in ref.completions.items():
        co = ours.completions[rid]
        assert (co.status, co.arrival, co.via, co.solver_status) == \
            (cr.status, cr.arrival, cr.via, cr.solver_status)
        assert co.finished == pytest.approx(cr.finished, rel=1e-12)
        if cr.status == "ok":
            assert abs(co.iters - cr.iters) <= 1
            xr = np.asarray(cr.x, np.float64)
            assert np.linalg.norm(_x(co) - xr) / np.linalg.norm(xr) < 1e-4


# ---------------------------------------------------------------------------
# the threaded front-end

class TestThreadedService:
    def test_concurrent_submitters_no_lost_or_duplicated(self, operator):
        from repro_torch.core.matvec import h2_matvec
        _, key, build, _ = operator
        svc = SolverService(OperatorCache(), panel_width=4,
                            restart_every=20, max_segments=20,
                            queue_capacity=8, tol=1e-6, **DEVICE)
        ts_ = ThreadedSolverService(svc, key, build)
        rng = np.random.default_rng(0)
        n_req, n_threads = 24, 4
        B = rng.standard_normal((n_req, N)).astype(np.float32)
        rids = {}
        lock = threading.Lock()

        def submitter(tid):
            for i in range(tid, n_req, n_threads):
                while True:
                    try:
                        rid = ts_.submit(B[i])
                        break
                    except QueueFull as e:
                        time.sleep(e.retry_after)
                with lock:
                    rids[i] = rid

        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(rids) == n_req and len(set(rids.values())) == n_req
        done = {i: ts_.result(rid, timeout=120) for i, rid in rids.items()}
        ts_.close(timeout=30)
        shape, data = ts_.entry.shape, ts_.entry.data
        for i, c in done.items():
            assert c.status == "ok"
            x = c.x[:, None]
            r = torch.as_tensor(B[i])[:, None] - (
                x + h2_matvec(shape, data, x, backend="torch"))
            assert float(r.norm()) <= 2e-6 * float(np.linalg.norm(B[i]))
        m = ts_.metrics
        assert m["submitted"] == n_req and m["completed"] == n_req
        assert m["duplicates"] == 0 and m["timeouts"] == 0
        assert m["dispatches"] < n_req

    def test_result_timeout_and_close_drains(self, operator):
        _, key, build, _ = operator
        svc = SolverService(OperatorCache(), panel_width=4,
                            restart_every=20, max_segments=20, tol=1e-6,
                            **DEVICE)
        ts_ = ThreadedSolverService(svc, key, build)
        rng = np.random.default_rng(1)
        rids = [ts_.submit(rng.standard_normal(N).astype(np.float32))
                for _ in range(6)]
        ts_.close(timeout=120)
        for rid in rids:
            assert ts_.result(rid, timeout=1).status == "ok"
        with pytest.raises(KeyError):
            ts_.result(999, timeout=0.01)

    def test_build_failure_reaches_the_constructor(self):
        def bad():
            raise RuntimeError("construction failed")
        svc = SolverService(OperatorCache(), **DEVICE)
        with pytest.raises(RuntimeError, match="construction failed"):
            ThreadedSolverService(svc, _key("x"), bad)

    def test_threaded_guard_trip_falls_back_per_column(self, operator):
        from repro_torch.solvers import STATUS_OK
        _, key, build, _ = operator
        svc = SolverService(OperatorCache(), panel_width=4,
                            restart_every=20, max_segments=20,
                            queue_capacity=8, tol=1e-6, **DEVICE)
        ts_ = ThreadedSolverService(svc, key, build)
        rng = np.random.default_rng(0)
        good = rng.standard_normal(N).astype(np.float32)
        bad = good.copy()
        bad[7] = np.nan
        rid_good, rid_bad = ts_.submit(good), ts_.submit(bad)
        cg = ts_.result(rid_good, timeout=120)
        cb = ts_.result(rid_bad, timeout=120)
        ts_.close(timeout=30)
        assert cg.status == "ok" and cg.via == "primary"
        assert cg.solver_status == STATUS_OK and cg.iters > 0
        assert cb.via == "degraded" and cb.solver_status != STATUS_OK
        assert ts_.metrics["guard_trips"] >= 1


# ---------------------------------------------------------------------------
# on the card: the programs are cached on the entry

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_second_service_captures_nothing(cuda):
    """The programs live on the cache entry: a second service on the same
    entry replays the first one's graphs (no capture) and serves the same
    answers bit for bit."""
    from repro_torch.core.clustering import regular_grid_points
    from repro_torch.core.construction import construct_h2
    from repro_torch.core.kernels_fn import exponential_kernel
    from repro_torch.solvers import krylov as pk

    pts = regular_grid_points(16, 2)
    key = OperatorKey(geometry=geometry_digest(pts),
                      kernel=("exponential", 0.1), tol=None)

    def build_card():
        shape, data, _, _ = construct_h2(pts, exponential_kernel(0.1),
                                         leaf_size=16, cheb_p=4, eta=0.9,
                                         device="cuda")
        return shape, data, {}

    cache = OperatorCache()
    kw = dict(panel_width=4, restart_every=20, max_segments=20, tol=1e-6,
              dispatch_cost=0.02, seed=0, device="cuda")
    first = SolverService(cache, **kw).serve(_load(n_requests=4).requests(),
                                             key, build_card)
    before = pk.TRACE_COUNTS["block_cg"]
    second = SolverService(cache, **kw).serve(
        _load(n_requests=4).requests(), key, build_card)
    assert pk.TRACE_COUNTS["block_cg"] == before
    assert cache.stats()["misses"] == 1
    for rid, c in first.completions.items():
        assert c.status == "ok" and c.x.is_cuda
        assert torch.equal(c.x, second.completions[rid].x)
