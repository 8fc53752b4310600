"""Fault-tolerant H^2 solver service (DESIGN.md §9), the port of the
reference's ``repro/serving/service.py``.

Ties the subsystem together: operator cache (``serving/cache``) ->
admission queue + continuous-batched panel (``serving/batching``) ->
segmented multi-RHS ``block_cg`` dispatches -> fault layer
(``runtime/fault``: deterministic injection, retry with exponential
backoff + jitter, straggler-hedged re-dispatch, circuit breaker with
degraded modes).

The loop is a discrete-event simulation over a **virtual clock**: arrivals
come from an open-loop generator with virtual timestamps, each solver
dispatch advances the clock by its (measured or modeled) duration, and
backoff/cooldown delays are virtual.  Solves are REAL (``block_cg``
segments over the actual H^2 operator, replayed from CUDA graphs on the
card); only time is virtual —
so a drill at a fixed seed is exactly reproducible (same batches, same
faults, same breaker transitions) while the solutions it serves are
bit-for-bit the subsystem's real output.  Every stage is wrapped in
``obs.trace.phase`` spans and mirrored into a host-side span list that
exports to a Chrome trace (``obs.export.write_span_trace``), so p99
latency decomposes into queue wait / solve / backoff / degraded time.

Failure semantics per dispatch (deterministic, keyed by a global dispatch
index): *device loss* raises ``StepFailure`` before the solve (via
``FailureInjector``); *nan* corrupts the returned iterate, caught by the
finite-check; *straggle* inflates the virtual duration, which trips the
``StragglerMonitor`` and triggers a hedged re-dispatch (the faster of the
two attempts wins).  Consecutive dispatch failures trip the per-operator
``CircuitBreaker``; while open, traffic is served degraded — single-RHS
``pcg`` on the primary operator (same tolerance, so answers stay correct),
or a looser-tol cached operator when ``degraded="loose"`` and one is
resident — until a half-open probe succeeds and the breaker re-closes.
Degraded dispatches bypass injection (they are the recovery path; faults
target the primary path only).

The port's solver programs are the closures ``solvers.block_cg`` and
``solvers.pcg`` run (the reference's ``jax.jit`` programs): cached on the
cache entry, so their captured CUDA graphs live as long as the entry and
a second service on the same entry captures nothing.  The panel lives on
``device``.  ``ThreadedSolverService``'s one worker thread does all the
device work (the operator's build included); submitters only enqueue.

Distributed serving (``OperatorKey.comm`` other than ``"local"``: the comm
mode of ``core.dist``): one ``SolverService`` per rank, each given the
rank's ``comm=`` (a ``core.comm.Comm``), serves the same request list in
lockstep.  ``build_fn`` returns the rank's shard (``partition_h2`` +
``local_shard``) with ``dshape`` in the extras; each rank's panel holds
its rows of ``b`` and ``x`` (rows ``rank * n_local`` on, cut from the
full-length requests, which a seeded ``PoissonLoad`` makes alike on every
rank), and ``block_cg``/``pcg`` run with ``comm=``, eagerly (a segment
with collectives is not captured).  Every decision is taken on replicated
values, since a rank that decided differently would hang the others at
the next collective: the solvers' residuals, iterations and statuses come
from rank-order ``psum``s; the finite check is psum'd; a dispatch measured
on the wall clock (``dispatch_cost=None``) costs the slowest rank's wall
(one gather), so the virtual clock, and with it admission, breaker,
retry, hedge and degrade, is the same on every rank.  ``gather_answers``
assembles the answers' rows.  A distributed key without ``comm`` is
refused.  ``ThreadedSolverService`` serves a distributed key live from
rank 0 (its docstring).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np

import torch

from repro_torch.guard.status import status_name, worst_status
from repro_torch.obs.trace import phase
from repro_torch.runtime.fault import (CircuitBreaker, FailureInjector,
                                       StepFailure, StragglerMonitor,
                                       backoff_delays)
from repro_torch.serving.batching import (Completion, PanelState, QueueFull,
                                          RequestQueue, SolveRequest)
from repro_torch.serving.cache import CacheEntry, OperatorCache, OperatorKey


@dataclasses.dataclass
class ServiceFaultPlan:
    """Deterministic fault schedule, keyed by primary-dispatch index."""
    device_loss_at: Dict[int, str] = dataclasses.field(default_factory=dict)
    nan_at: Set[int] = dataclasses.field(default_factory=set)
    straggle_at: Dict[int, float] = dataclasses.field(default_factory=dict)

    def empty(self) -> bool:
        return not (self.device_loss_at or self.nan_at or self.straggle_at)


@dataclasses.dataclass
class ServeReport:
    """Outcome of one serve run: terminal record per request + counters +
    host-side spans (virtual-time Chrome-trace events)."""
    completions: Dict[int, Completion]
    metrics: Dict[str, Any]
    spans: List[dict]

    def latencies(self, status: str = "ok") -> np.ndarray:
        lats = [c.latency for c in self.completions.values()
                if c.status == status]
        return np.asarray(sorted(lats), np.float64)

    def percentile(self, p: float) -> float:
        lats = self.latencies()
        return float(np.percentile(lats, p)) if lats.size else math.nan

    def dispatch_log(self) -> List[tuple]:
        """The episode's dispatches, backoffs and their virtual times:
        every span but the operator's acquisition (whose duration is this
        host's wall clock).  Equal on every rank of a distributed serve."""
        return [(sp["name"], sp["ts"], sp["dur"],
                 tuple(sorted(sp["args"].items())))
                for sp in self.spans if sp["name"] != "serve/operator"]


def default_make_apply(shape, backend: str = "cuda"):
    """The served system: SPD covariance solve ``(I + A) x = b`` (the
    spatial-statistics staple from ``examples/serve_h2_solver``), its
    HGEMV on ``backend``."""
    from repro_torch.core.matvec import h2_matvec

    def apply(data, x):
        return x + h2_matvec(shape, data, x, backend=backend)
    return apply


def default_make_dist_apply(dshape, comm, mode: str, backend: str = "cuda"):
    """The served system on a rank's shard: ``x + A x`` on its rows, the
    distributed HGEMV (``core.dist.make_dist_matvec``) in comm ``mode``."""
    from repro_torch.core.dist import make_dist_matvec

    mv = make_dist_matvec(dshape, comm, mode, backend)

    def apply(data, x):
        return x + mv(data, x)
    return apply


def gather_answers(report: ServeReport, comm) -> Dict[int, torch.Tensor]:
    """rid -> the whole ``Completion.x`` of a distributed serve, its rows
    gathered from every rank in rank order (every rank calls it; the
    completions are the same on every rank)."""
    return {rid: comm.all_gather(c.x)
            for rid, c in sorted(report.completions.items())
            if c.x is not None}


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _check_key(key: OperatorKey, comm) -> None:
    if key.comm != "local" and comm is None:
        raise NotImplementedError(
            f"OperatorKey.comm={key.comm!r}: serving a distributed operator "
            f"needs a SolverService on every rank in lockstep; pass each "
            f"rank's comm=")


class SolverService:
    """Serve Krylov solves against cached H^2 operators.

    One instance owns the cache, the admission queue, the fault machinery
    and the virtual clock; ``serve(requests, key, build_fn)`` runs a full
    drill/benchmark episode and returns a ``ServeReport``.

    ``dispatch_cost``: virtual seconds per segment dispatch — ``None``
    uses the measured wall time of the real solve (synchronized;
    benchmark mode); a float or ``callable(active_columns) -> s`` makes
    the clock fully deterministic (drill/test mode): then no wall time
    enters a decision.  ``device``: where the panel lives (the operator's
    device); ``backend``: the default ``make_apply``'s HGEMV backend.
    ``comm``: this rank's ``Comm`` for distributed keys (module
    docstring).  ``make_apply(shape)`` overrides the served system's
    operator for every key; by default a local key applies
    ``default_make_apply`` and a distributed one
    ``default_make_dist_apply`` on the entry's ``dshape``.
    """

    def __init__(self, cache: Optional[OperatorCache] = None, *,
                 panel_width: int = 8, restart_every: int = 25,
                 max_segments: int = 40, queue_capacity: int = 64,
                 queue_drain_hint: float = 0.05,
                 tol: float = 1e-6, max_retries: int = 3,
                 max_resubmits: int = 5,
                 fault_plan: Optional[ServiceFaultPlan] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 straggler: Optional[StragglerMonitor] = None,
                 hedging: bool = True, degraded: str = "pcg",
                 degraded_tol: float = 1e-3,
                 dispatch_cost: Optional[Any] = None,
                 detect_delay: float = 5e-3, seed: int = 0,
                 make_apply: Optional[Callable] = None,
                 device="cuda", backend: str = "cuda", comm=None):
        self.cache = cache if cache is not None else OperatorCache()
        self.panel_width = int(panel_width)
        self.restart_every = int(restart_every)
        self.max_segments = int(max_segments)
        self.queue_capacity = int(queue_capacity)
        self.queue_drain_hint = float(queue_drain_hint)
        self.tol = float(tol)
        self.max_retries = int(max_retries)
        self.max_resubmits = int(max_resubmits)
        self.plan = fault_plan if fault_plan is not None else \
            ServiceFaultPlan()
        self.injector = FailureInjector(fail_at=dict(
            self.plan.device_loss_at))
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.straggler = straggler if straggler is not None else \
            StragglerMonitor(threshold=3.0, warmup=2)
        self.hedging = bool(hedging)
        assert degraded in ("pcg", "loose"), degraded
        self.degraded = degraded
        self.degraded_tol = float(degraded_tol)
        self.dispatch_cost = dispatch_cost
        self.detect_delay = float(detect_delay)
        self.make_apply = make_apply
        self.backend = backend
        self.comm = comm
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        self.dispatch_idx = 0           # primary dispatches (fault-keyed)
        self.spans: List[dict] = []
        self.metrics: Dict[str, Any] = {
            k: 0 for k in ("dispatches", "dispatch_failures", "retries",
                           "hedges", "hedge_wins", "degraded_dispatches",
                           "completed", "timeouts", "rejected", "resubmits",
                           "unconverged", "guard_trips")}
        self._occupancy: List[int] = []

    # -- operator acquisition (cache-aside) -----------------------------
    def operator(self, key: OperatorKey,
                 build_fn: Callable[[], Tuple[Any, Any, Dict]]
                 ) -> CacheEntry:
        _check_key(key, self.comm)
        return self.cache.get_or_build(key, build_fn)

    def _dist(self, entry: CacheEntry) -> bool:
        return entry.key.comm != "local"

    def _apply(self, entry: CacheEntry):
        if self.make_apply is not None:
            return self.make_apply(entry.shape)
        if self._dist(entry):
            return default_make_dist_apply(entry.extra["dshape"], self.comm,
                                           entry.key.comm, self.backend)
        return default_make_apply(entry.shape, self.backend)

    def _rows(self, entry: CacheEntry) -> Tuple[int, int]:
        """(rows this rank holds, its first row)."""
        if not self._dist(entry):
            return entry.shape.n, 0
        n_local = entry.extra["dshape"].n_local()
        return n_local, self.comm.rank * n_local

    # -- solver programs, cached on the entry ---------------------------
    def _segment_fn(self, entry: CacheEntry, maxiter: int):
        from repro_torch.solvers import block_cg

        skey = ("seg", self.panel_width, maxiter)
        if skey not in entry.solvers:
            apply, data = self._apply(entry), entry.data

            def op(v):
                return apply(data, v)
            entry.solvers[skey] = op
        op = entry.solvers[skey]
        comm = self.comm if self._dist(entry) else None

        def call(b, x0, tol):
            res = block_cg(op, b, x0=x0, tol=tol, maxiter=maxiter,
                           comm=comm)
            _sync(res.x)
            return res
        return call

    def _pcg_fn(self, entry: CacheEntry):
        from repro_torch.solvers import pcg

        budget = self.restart_every * self.max_segments
        skey = ("pcg", budget)
        if skey not in entry.solvers:
            apply, data = self._apply(entry), entry.data

            def one(v):
                return apply(data, v[:, None])[:, 0]
            entry.solvers[skey] = one
        one = entry.solvers[skey]
        comm = self.comm if self._dist(entry) else None

        def call(b, tol):
            res = pcg(one, b.contiguous(), tol=tol, maxiter=budget,
                      comm=comm)
            _sync(res.x)
            return res
        return call

    # -- fault-wrapped dispatch -----------------------------------------
    def _all_finite(self, x: torch.Tensor) -> bool:
        """Whether every rank's ``x`` is finite (a psum'd count when
        distributed, so every rank reads the same answer)."""
        bad = (~torch.isfinite(x)).sum().to(torch.float32)
        if self.comm is not None and self.comm.p > 1:
            bad = self.comm.psum(bad)
        return not bool(bad)

    def _virtual_cost(self, wall: float, active: int) -> float:
        if self.dispatch_cost is None:
            if self.comm is not None and self.comm.p > 1:
                # the slowest rank's wall: the same clock on every rank
                walls = self.comm.all_gather(torch.tensor(
                    [wall], dtype=torch.float64, device=self.device))
                return float(walls.max())
            return wall
        if callable(self.dispatch_cost):
            return float(self.dispatch_cost(active))
        return float(self.dispatch_cost)

    def _try_dispatch(self, seg, entry: CacheEntry, panel: PanelState,
                      tol: float) -> Tuple[Any, float]:
        """One primary dispatch through the injection hooks.  Returns
        (SolveResult, virtual duration); raises StepFailure (with a
        ``duration`` attribute) on device loss or solver divergence."""
        idx = self.dispatch_idx
        self.dispatch_idx += 1
        self.metrics["dispatches"] += 1
        try:
            self.injector.check(idx)    # simulated device loss
        except StepFailure as e:
            e.duration = self.detect_delay
            raise
        t0 = time.perf_counter()
        with phase("serve/solve"):
            res = seg(panel.b, panel.x, tol)
        wall = time.perf_counter() - t0
        dur = self._virtual_cost(wall, panel.occupancy) \
            + self.plan.straggle_at.get(idx, 0.0)
        if idx in self.plan.nan_at:     # simulated solver blow-up
            # poison a copy: the result is never a graph's static buffer
            res = dataclasses.replace(res, x=res.x * float("nan"))
        if not self._all_finite(res.x):
            e = StepFailure("solver diverged (non-finite iterate)")
            e.duration = dur
            raise e
        # the solver's own breakdown guard: a NaN / indefinite / stagnated
        # column is a dispatch failure (the breaker consumes it like a
        # device loss) — the recomputed-x finite check above only catches
        # the NaN case, and only after the fact
        code = worst_status(getattr(res, "status", None))
        if code != 0:
            self.metrics["guard_trips"] += 1
            e = StepFailure(f"solver guard tripped "
                            f"({status_name(code)})")
            e.duration = dur
            e.status = code
            raise e
        if self.straggler.record(idx, dur) and self.hedging:
            res, dur = self._hedge(seg, entry, panel, tol, res, dur)
        return res, dur

    def _hedge(self, seg, entry, panel, tol, res_p, primary_dur: float):
        """Hedged re-dispatch after a straggler flag: issue a second
        attempt, keep whichever finishes first (tied-request hedging).
        Deterministic solves make the two results identical, so only the
        duration — and the counters — differ."""
        self.metrics["hedges"] += 1
        idx = self.dispatch_idx
        self.dispatch_idx += 1
        try:
            self.injector.check(idx)
            t0 = time.perf_counter()
            with phase("serve/hedge"):
                res = seg(panel.b, panel.x, tol)
            wall = time.perf_counter() - t0
            dur = self._virtual_cost(wall, panel.occupancy) \
                + self.plan.straggle_at.get(idx, 0.0)
            if not self._all_finite(res.x):
                return res_p, primary_dur
        except StepFailure:
            return res_p, primary_dur   # hedge lost; primary stands
        if dur < primary_dur:
            self.metrics["hedge_wins"] += 1
            return res, dur
        return res_p, primary_dur

    def _degraded_segment(self, entry: CacheEntry, panel: PanelState,
                          clock: float) -> Tuple[np.ndarray, float]:
        """Serve the active columns without the primary path: looser-tol
        cached operator if configured+resident, else single-RHS ``pcg``
        on the primary operator at full budget.  Returns (relres [width],
        virtual duration); panel.x/iters updated in place."""
        self.metrics["degraded_dispatches"] += 1
        relres = np.full((panel.width,), np.inf, np.float64)
        total = 0.0
        alt = None
        if self.degraded == "loose":
            alt = self.cache.lookup_loosest(entry.key,
                                            max_tol=self.degraded_tol)
        if alt is not None:
            seg = self._segment_fn(alt, self.restart_every
                                   * self.max_segments)
            t0 = time.perf_counter()
            with phase("serve/degraded"):
                res = seg(panel.b, panel.x, panel.tightest_tol(self.tol))
            total = self._virtual_cost(time.perf_counter() - t0,
                                       panel.occupancy)
            panel.x = res.x
            panel.iters += res.iters.cpu().numpy().astype(np.int64)
            relres = res.relres.cpu().numpy().astype(np.float64)
            panel.status[:] = res.status.cpu().numpy()
            for j, req in enumerate(panel.reqs):
                if req is not None:
                    panel.degraded[j] = True
            return relres, total
        one = self._pcg_fn(entry)
        for j, req in enumerate(panel.reqs):
            if req is None:
                continue
            t0 = time.perf_counter()
            with phase("serve/degraded"):
                res = one(panel.b[:, j], req.tol)
            total += self._virtual_cost(time.perf_counter() - t0, 1)
            panel.x[:, j] = res.x
            panel.iters[j] += int(res.iters)
            relres[j] = float(res.relres)
            panel.status[j] = worst_status(getattr(res, "status", None))
            panel.degraded[j] = True
        return relres, total

    def _dispatch_with_faults(self, entry: CacheEntry, panel: PanelState,
                              clock: float) -> Tuple[np.ndarray, float]:
        """One segment boundary's worth of solving, through retry/backoff,
        hedging, and the circuit breaker.  Returns (relres, elapsed)."""
        seg = self._segment_fn(entry, self.restart_every)
        tol = panel.tightest_tol(self.tol)
        elapsed = 0.0
        attempt = 0
        while True:
            if not self.breaker.allow(clock + elapsed):
                relres, dur = self._degraded_segment(entry, panel,
                                                     clock + elapsed)
                return relres, elapsed + dur
            try:
                res, dur = self._try_dispatch(seg, entry, panel, tol)
            except StepFailure as e:
                elapsed += getattr(e, "duration", self.detect_delay)
                self.metrics["dispatch_failures"] += 1
                self.breaker.record_failure(clock + elapsed)
                attempt += 1
                if attempt > self.max_retries:
                    relres, dur = self._degraded_segment(entry, panel,
                                                         clock + elapsed)
                    return relres, elapsed + dur
                delay = backoff_delays(attempt - 1, rng=self._rng)
                self.metrics["retries"] += 1
                self._span("serve/retry-backoff", clock + elapsed, delay,
                           {"attempt": attempt})
                elapsed += delay
                continue
            elapsed += dur
            self.breaker.record_success(clock + elapsed)
            panel.x = res.x
            panel.iters += res.iters.cpu().numpy().astype(np.int64)
            panel.status[:] = res.status.cpu().numpy()
            return res.relres.cpu().numpy().astype(np.float64), elapsed

    # -- the serve loop --------------------------------------------------
    def _span(self, name: str, t0: float, dur: float,
              args: Optional[Dict] = None) -> None:
        self.spans.append({"name": name, "ts": t0 * 1e6,
                           "dur": max(dur, 1e-9) * 1e6,
                           "args": args or {}})

    def serve(self, requests: List[SolveRequest], key: OperatorKey,
              build_fn: Callable[[], Tuple[Any, Any, Dict]]) -> ServeReport:
        """Run the discrete-event serve loop over ``requests`` (virtual
        arrival times) against the operator at ``key`` (built through the
        cache on first use)."""
        # per-episode state: each ServeReport describes one serve() call.
        # dispatch_idx is deliberately NOT reset (fault plans key on the
        # global index) and the breaker keeps its state across episodes.
        self.metrics = {k: 0 for k in self.metrics}
        self.spans = []
        self._occupancy = []
        with phase("serve/operator"):
            t0 = time.perf_counter()
            entry = self.operator(key, build_fn)
            self._span("serve/operator", 0.0, time.perf_counter() - t0,
                       {"cache": self.cache.stats()})
        queue = RequestQueue(self.queue_capacity,
                             drain_hint=self.queue_drain_hint)
        rows, row0 = self._rows(entry)
        panel = PanelState(n=rows, width=self.panel_width,
                           device=self.device, row0=row0)
        completions: Dict[int, Completion] = {}
        max_total_iters = self.restart_every * self.max_segments
        clock = 0.0
        seq = 0
        events: List[Tuple[float, int, SolveRequest]] = []
        for r in requests:
            heapq.heappush(events, (r.arrival, seq, r))
            seq += 1

        def admit_due():
            nonlocal seq
            with phase("serve/admit"):
                while events and events[0][0] <= clock:
                    _, _, req = heapq.heappop(events)
                    if req.expired(clock):
                        self.metrics["timeouts"] += 1
                        completions[req.rid] = Completion(
                            req.rid, "timeout", req.arrival, clock)
                        continue
                    try:
                        queue.offer(req)
                    except QueueFull as e:
                        req.attempts += 1
                        if req.attempts <= self.max_resubmits:
                            self.metrics["resubmits"] += 1
                            heapq.heappush(
                                events,
                                (clock + e.retry_after, seq, req))
                            seq += 1
                        else:
                            self.metrics["rejected"] += 1
                            completions[req.rid] = Completion(
                                req.rid, "rejected", req.arrival, clock)

        while events or len(queue) or panel.occupancy:
            admit_due()
            free = panel.free_slots()
            if free:
                live, dead = queue.take(len(free), clock)
                for d in dead:
                    self.metrics["timeouts"] += 1
                    completions[d.rid] = Completion(d.rid, "timeout",
                                                    d.arrival, clock)
                if live:
                    panel.admit(live)
            if panel.occupancy == 0:
                if events:              # idle: jump to the next arrival
                    clock = max(clock, events[0][0])
                    continue
                if len(queue):
                    continue            # only expired stragglers remain
                break
            self._occupancy.append(panel.occupancy)
            t_disp = clock
            relres, elapsed = self._dispatch_with_faults(entry, panel,
                                                         clock)
            clock += elapsed
            self._span("serve/dispatch", t_disp, elapsed,
                       {"active": int(self._occupancy[-1]),
                        "breaker": self.breaker.state})
            with phase("serve/retire"):
                for j, req in enumerate(panel.reqs):
                    if req is None:
                        continue
                    if req.expired(clock):
                        self.metrics["timeouts"] += 1
                        completions[req.rid] = Completion(
                            req.rid, "timeout", req.arrival, clock)
                        panel.evict(j)
                        continue
                    done = relres[j] <= req.tol
                    out_of_budget = panel.iters[j] >= max_total_iters
                    if done or out_of_budget:
                        if not done:
                            self.metrics["unconverged"] += 1
                        self.metrics["completed"] += 1
                        completions[req.rid] = Completion(
                            req.rid, "ok" if done else "failed",
                            req.arrival, clock, x=panel.x[:, j].clone(),
                            iters=int(panel.iters[j]),
                            relres=float(relres[j]),
                            via="degraded" if panel.degraded[j]
                            else "primary",
                            solver_status=int(panel.status[j]))
                        panel.evict(j)

        m = dict(self.metrics)
        m["makespan_s"] = clock
        m["mean_occupancy"] = (float(np.mean(self._occupancy))
                               if self._occupancy else 0.0)
        m["panel_width"] = self.panel_width
        m["breaker_trips"] = self.breaker.trips
        m["breaker_recoveries"] = self.breaker.recoveries
        m["breaker_transitions"] = list(self.breaker.transitions)
        m["queue_rejections"] = queue.rejected
        m["queue_peak_depth"] = queue.peak_depth
        m["cache"] = self.cache.stats()
        return ServeReport(completions=completions, metrics=m,
                           spans=list(self.spans))


class ThreadedSolverService:
    """Real-thread front-end over the same cache/panel/segment machinery.

    Where ``SolverService.serve`` replays a pre-known request list on a
    virtual clock, this runs live: ``submit(b)`` may be called from any
    number of threads (backpressure surfaces as ``QueueFull``, exactly as
    in the virtual loop) while a single solver thread drains the
    admission queue into the continuous-batched panel and runs the same
    ``block_cg`` segments — late arrivals join at the next restart
    boundary.  ``result(rid)`` blocks on a per-request event; every
    request completes exactly once (``metrics["duplicates"]`` counts
    would-be double publishes and must stay 0 — the concurrency smoke
    test asserts it).

    The solver thread owns all device work: it acquires the operator
    (``__init__`` waits for it and re-raises a failed build), the panel
    and the completions; submitters only enqueue host arrays.  The lock
    only guards the queue and the completion/event maps, so the segments
    run lock-free.

    A distributed key (``service.comm`` given) runs one such service per
    rank, in lockstep.  Rank 0 is the front end: ``submit`` and
    ``result`` work there only.  At each restart boundary rank 0 takes
    the admissions and the expired requests from its own queue and clock
    and decides whether to stop (``_decide``, the local service's rule),
    then hands the decision to every rank (``_exchange``): a header
    broadcast (``Comm.broadcast``, counted as ``broadcast``) with the stop
    flag, the admitted and expired counts, the submitted count and each
    admitted request's rid, tol, deadline and arrival, sized by the free
    slots, which every rank knows; and, only when requests were admitted,
    their right-hand sides scattered (``Comm.scatter``, counted as
    ``scatter``), each rank receiving its own rows.  Both travel on the
    panel's device; ``Comm`` picks the transport.  Every rank then runs
    the same segments over its rows, with the psum'd residuals, statuses
    and finite checks of ``SolverService``, so every rank retires the
    same columns; the answers' rows are gathered to rank 0, which
    publishes each once.  The other ranks wait for the next decision in
    the header broadcast, so while idle rank 0 sends an empty one every
    ``heartbeat`` seconds, well inside the process group's timeout.  The
    worker thread is the only issuer of collectives on the service's
    group while it runs (gloo requires one order per group: a caller that
    needs a barrier meanwhile uses another group).  ``close()`` on rank 0
    travels as the stop flag; on the other ranks it waits for it.
    ``metrics`` are equal on every rank at every boundary.
    """

    # decision header (float64): stop, admitted, expired, submitted; then
    # per admitted request: rid, tol, deadline, arrival
    _HEAD, _PER_REQ = 4, 4

    def __init__(self, service: SolverService, key: OperatorKey,
                 build_fn: Callable[[], Tuple[Any, Any, Dict]],
                 poll: float = 0.002, heartbeat: float = 60.0):
        _check_key(key, service.comm)
        self.service = service
        self._comm = service.comm if key.comm != "local" else None
        self.rank = self._comm.rank if self._comm is not None else 0
        self._queue = RequestQueue(service.queue_capacity,
                                   drain_hint=service.queue_drain_hint)
        self._poll = float(poll)
        self._heartbeat = float(heartbeat)
        self._exchanged = time.monotonic()
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = False
        self._completions: Dict[int, Completion] = {}
        self._done: Dict[int, threading.Event] = {}
        self._rids = itertools.count()
        self.metrics: Dict[str, int] = {
            "submitted": 0, "completed": 0, "timeouts": 0,
            "dispatches": 0, "duplicates": 0, "guard_trips": 0}
        self.boundaries = 0             # decisions exchanged (distributed)
        self.entry: Optional[CacheEntry] = None
        self._ready = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run,
                                        args=(key, build_fn), daemon=True)
        self._thread.start()
        self._ready.wait()
        if self._error is not None:
            self._thread.join()
            raise self._error

    # -- submitter side --------------------------------------------------
    def _front_end(self, what: str) -> None:
        if self.rank != 0:
            raise RuntimeError(f"{what} on rank {self.rank}: a distributed "
                               f"threaded service is served from rank 0")

    def submit(self, b, tol: Optional[float] = None,
               deadline: float = math.inf) -> int:
        """Enqueue one RHS (host array, all ``n`` rows); returns its rid.
        Raises ``QueueFull`` when the admission queue is at capacity
        (callers back off and retry — the same contract as the virtual
        loop's resubmit path)."""
        self._front_end("submit")
        b = np.asarray(b, np.float32)
        if b.shape != (self.entry.shape.n,):
            raise ValueError(f"right-hand side of shape {b.shape}, the "
                             f"operator has {self.entry.shape.n} rows")
        rid = next(self._rids)
        req = SolveRequest(rid=rid, b=b,
                           arrival=time.monotonic(), deadline=deadline,
                           tol=self.service.tol if tol is None else
                           float(tol))
        with self._lock:
            self._raise_failure()
            if self._stop:                  # the worker may have left
                raise RuntimeError("submit after close()")
            self._queue.offer(req)          # may raise QueueFull
            self._done[rid] = threading.Event()
            self.metrics["submitted"] += 1
        self._work.set()
        return rid

    def result(self, rid: int, timeout: Optional[float] = None
               ) -> Completion:
        self._front_end("result")
        with self._lock:
            evt = self._done[rid]
        if not evt.wait(timeout):
            raise TimeoutError(f"request {rid} not completed")
        with self._lock:
            if rid not in self._completions:
                self._raise_failure()
            return self._completions[rid]

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain outstanding work, then stop the solver thread (on every
        rank: rank 0 decides the stop, the others wait for it).  Raises
        if the solver thread failed."""
        if self.rank == 0:
            with self._lock:
                self._stop = True
            self._work.set()
        self._thread.join(timeout)
        self._raise_failure()

    def _raise_failure(self) -> None:
        if self._error is not None:
            raise RuntimeError(f"the solver thread on rank {self.rank} "
                               f"failed") from self._error

    # -- solver thread ---------------------------------------------------
    def _publish(self, req: SolveRequest, status: str,
                 x: Optional[torch.Tensor], iters: int, relres: float,
                 via: str = "primary", solver_status: int = 0) -> None:
        if self.rank != 0:              # rank 0 publishes; count alike
            self.metrics["completed"] += 1
            return
        c = Completion(req.rid, status, req.arrival, time.monotonic(),
                       x=x, iters=iters, relres=relres, via=via,
                       solver_status=solver_status)
        with self._lock:
            if req.rid in self._completions:
                self.metrics["duplicates"] += 1
                return
            self._completions[req.rid] = c
            self.metrics["completed"] += 1
            self._done[req.rid].set()

    def _decide(self, panel: PanelState):
        """Rank 0's boundary decision from its queue and clock:
        (admitted, expired, stop), or None while idle (nothing to admit,
        expire or stop, an empty panel)."""
        free = len(panel.free_slots())
        with self._lock:
            live, dead = (self._queue.take(free, time.monotonic())
                          if free else ([], []))
            stop = self._stop and len(self._queue) == 0
        if live or dead or panel.occupancy:
            return live, dead, False
        return ([], [], True) if stop else None

    def _exchange(self, panel: PanelState, step):
        """Every rank's copy of rank 0's decision ``step`` (None: idle, a
        heartbeat): (admitted, expired, stop, this rank's rows of the
        admitted), or None while idle.  The expired are rank 0's requests
        there and rid-only stand-ins elsewhere."""
        comm, free = self._comm, len(panel.free_slots())
        head = torch.zeros(self._HEAD + self._PER_REQ * free,
                           dtype=torch.float64)
        live, dead, stop = step if step is not None else ([], [], False)
        if self.rank == 0:
            vals = [float(stop), len(live), len(dead),
                    self.metrics["submitted"]]
            for req in live:
                vals += [req.rid, req.tol, req.deadline, req.arrival]
            head[:len(vals)] = torch.tensor(vals, dtype=torch.float64)
        head = comm.broadcast(head.to(panel.b.device),
                              kind="broadcast").tolist()
        self._exchanged = time.monotonic()
        self.boundaries += 1
        n_live, n_dead = int(head[1]), int(head[2])
        rows = None
        if n_live:
            parts = None
            if self.rank == 0:              # [p, admitted, n_local]
                b = np.stack([req.b for req in live]).reshape(
                    n_live, comm.p, panel.n).transpose(1, 0, 2)
                parts = torch.from_numpy(np.ascontiguousarray(b)).to(
                    panel.b.device)
            rows = comm.scatter(parts, (n_live, panel.n), panel.b,
                                kind="scatter")
        if self.rank != 0:
            self.metrics["submitted"] = int(head[3])
            stop = bool(head[0])
            live = [SolveRequest(rid=int(rid), b=None, arrival=arrival,
                                 deadline=deadline, tol=tol)
                    for rid, tol, deadline, arrival in (
                        head[self._HEAD + self._PER_REQ * i:
                             self._HEAD + self._PER_REQ * (i + 1)]
                        for i in range(n_live))]
            dead = [SolveRequest(rid=-1, b=None, arrival=0.0)] * n_dead
        if not (live or dead or stop or panel.occupancy):
            return None
        return live, dead, stop, rows

    def _boundary(self, panel: PanelState):
        """(admitted, expired, stop, rows) at a restart boundary, or None
        while idle (rank 0 then waits for work).  Rank 0 decides; a
        distributed service exchanges the decision, and while idle an
        empty one once ``heartbeat`` seconds have passed."""
        step = self._decide(panel) if self.rank == 0 else None
        if self._comm is None:
            step = None if step is None else (*step, None)
        elif self.rank != 0 or step is not None or (
                time.monotonic() - self._exchanged >= self._heartbeat):
            step = self._exchange(panel, step)
        if step is None and self.rank == 0:
            self._work.wait(self._poll)
            self._work.clear()
        return step

    def _run(self, key: OperatorKey, build_fn) -> None:
        svc = self.service
        try:
            self.entry = svc.operator(key, build_fn)
            seg = svc._segment_fn(self.entry, svc.restart_every)
            one = svc._pcg_fn(self.entry)   # guard-trip fallback
            rows, row0 = svc._rows(self.entry)
            panel = PanelState(n=rows, width=svc.panel_width,
                               device=svc.device, row0=row0)
        except BaseException as e:          # handed to the constructor
            self._error = e
            return
        finally:
            self._ready.set()
        try:
            self._serve(panel, seg, one)
        except BaseException as e:      # result(), submit(), close() raise it
            self._error = e
            with self._lock:
                self._stop = True
                for evt in self._done.values():
                    evt.set()

    def _serve(self, panel: PanelState, seg, one) -> None:
        svc = self.service
        max_total_iters = svc.restart_every * svc.max_segments
        while True:
            step = self._boundary(panel)
            if step is None:
                continue
            live, dead, stop, b_rows = step
            for d in dead:
                self.metrics["timeouts"] += 1
                self._publish(d, "timeout", None, 0, math.nan)
            if stop:
                return
            if live:
                panel.admit(live, b_rows)
            if panel.occupancy == 0:
                continue
            with phase("serve/solve"):
                res = seg(panel.b, panel.x, panel.tightest_tol(svc.tol))
            self.metrics["dispatches"] += 1
            panel.x = res.x
            panel.iters += res.iters.cpu().numpy().astype(np.int64)
            relres = res.relres.cpu().numpy().astype(np.float64)
            panel.status[:] = res.status.cpu().numpy()
            # per-column fallback: a guard-tripped column (NaN /
            # indefinite / stagnated) gets one full-budget single-RHS pcg
            # retry and its completion is marked via="degraded" so the
            # client can tell it converged through the fallback
            for j, req in enumerate(panel.reqs):
                if req is None or panel.status[j] == 0:
                    continue
                self.metrics["guard_trips"] += 1
                with phase("serve/degraded"):
                    r1 = one(panel.b[:, j], req.tol)
                panel.x[:, j] = r1.x
                panel.iters[j] += int(r1.iters)
                relres[j] = float(r1.relres)
                panel.status[j] = worst_status(r1.status)
                panel.degraded[j] = True
            done = [j for j, req in enumerate(panel.reqs)
                    if req is not None and (
                        relres[j] <= req.tol or panel.degraded[j]
                        or panel.iters[j] >= max_total_iters)]
            if not done:
                continue
            xs = panel.x[:, done]
            if self._comm is not None:      # every rank's rows, rank order
                xs = self._comm.all_gather(xs)
            for i, j in enumerate(done):
                req = panel.reqs[j]
                ok = relres[j] <= req.tol
                self._publish(req, "ok" if ok else "failed",
                              xs[:, i].clone(), int(panel.iters[j]),
                              float(relres[j]),
                              via="degraded" if panel.degraded[j]
                              else "primary",
                              solver_status=int(panel.status[j]))
                panel.evict(j)
