"""Admission control + continuous RHS batching (DESIGN.md §9), the port
of the reference's ``repro/serving/batching.py``.

Requests carry one right-hand side each; the service solves them through
the multi-RHS ``block_cg``, whose per-column convergence masking makes a
*panel* the natural scheduling unit: a fixed-width ``[n, panel_width]``
block where each column is an independent CG recurrence.  Continuous
batching runs the panel in fixed-length segments (``restart_every``
iterations per dispatch, warm-started with ``x0``); at every segment
boundary converged columns retire and queued requests take over the freed
slots.  Empty slots are zero columns — ``block_cg``'s ``b = 0 -> converged
at iteration 0`` semantics means padding is masked off from the first
iteration and costs no convergence work.  The panel width is static, so
the whole serve loop runs ONE captured segment program per operator — no
recapture as occupancy fluctuates.  The panel's ``b`` and ``x`` live on
the service's device (the reference keeps them in host numpy): a
request's right-hand side is copied there once, at admission, and a
completion's ``x`` is a device tensor.

Admission is a bounded FIFO with backpressure (load-leveling pattern): a
full queue rejects with a ``retry_after`` hint instead of queueing
unboundedly, and expired requests are dropped at the boundary rather than
wasting solver iterations.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Deque, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class SolveRequest:
    """One RHS to solve against a cached operator."""
    rid: int
    b: np.ndarray                       # [n] right-hand side (tree order;
                                        # numpy or a tensor)
    arrival: float                      # virtual arrival time (s)
    deadline: float = math.inf          # absolute virtual time
    tol: float = 1e-6
    attempts: int = 0                   # client resubmissions so far

    def expired(self, now: float) -> bool:
        return now >= self.deadline


@dataclasses.dataclass
class Completion:
    """Terminal record of a request (served, expired, or rejected)."""
    rid: int
    status: str                         # "ok" | "timeout" | "rejected"
    arrival: float
    finished: float
    x: Optional[torch.Tensor] = None    # [n] on the service's device
    iters: int = 0
    relres: float = math.nan
    # how the answer was produced: "primary" = the batched block_cg path,
    # "degraded" = a fallback (per-column pcg / looser-tol operator) — so
    # clients can tell "converged via fallback" from "converged normally"
    via: str = "primary"
    solver_status: int = 0              # worst solvers.STATUS_* code seen

    @property
    def latency(self) -> float:
        return self.finished - self.arrival


class QueueFull(RuntimeError):
    """Backpressure signal: retry after ``retry_after`` seconds."""

    def __init__(self, retry_after: float):
        super().__init__(f"queue full, retry after {retry_after:.3f}s")
        self.retry_after = retry_after


class RequestQueue:
    """Bounded FIFO admission queue.

    ``offer`` raises ``QueueFull`` (with a retry-after hint proportional to
    the current backlog drain estimate) when at capacity; ``take`` pops up
    to ``k`` unexpired requests and returns expired ones separately so the
    caller can record timeouts.
    """

    def __init__(self, capacity: int, drain_hint: float = 0.05):
        self.capacity = int(capacity)
        self.drain_hint = float(drain_hint)   # est. seconds per queued req
        self._q: Deque[SolveRequest] = deque()
        self.rejected = 0
        self.admitted = 0
        self.peak_depth = 0

    def __len__(self) -> int:
        return len(self._q)

    def offer(self, req: SolveRequest) -> None:
        if len(self._q) >= self.capacity:
            self.rejected += 1
            raise QueueFull(retry_after=max(self.drain_hint,
                                            len(self._q) * self.drain_hint))
        self._q.append(req)
        self.admitted += 1
        self.peak_depth = max(self.peak_depth, len(self._q))

    def take(self, k: int, now: float
             ) -> (List[SolveRequest], List[SolveRequest]):
        """Pop up to ``k`` live requests; also drain+return expired ones."""
        live: List[SolveRequest] = []
        dead: List[SolveRequest] = []
        while self._q and len(live) < k:
            req = self._q.popleft()
            (dead if req.expired(now) else live).append(req)
        return live, dead


@dataclasses.dataclass
class PanelState:
    """State of the in-flight multi-RHS panel.

    ``reqs[j]`` is the request occupying column ``j`` (None = free slot);
    ``b``/``x`` are the ``[n, width]`` RHS and current iterate on
    ``device`` (zeros in free slots); ``iters[j]`` accumulates across
    segments (host numpy, as the per-column guard state).  A rank of a
    distributed serve holds rows ``row0 .. row0 + n`` of each request.
    """
    n: int
    width: int
    dtype: torch.dtype = torch.float32
    device: Any = "cuda"
    row0: int = 0
    reqs: List[Optional[SolveRequest]] = dataclasses.field(
        default_factory=list)
    b: torch.Tensor = dataclasses.field(default=None)
    x: torch.Tensor = dataclasses.field(default=None)
    iters: np.ndarray = dataclasses.field(default=None)

    def __post_init__(self):
        self.reqs = [None] * self.width
        self.b = torch.zeros((self.n, self.width), dtype=self.dtype,
                             device=self.device)
        self.x = torch.zeros_like(self.b)
        self.iters = np.zeros((self.width,), np.int64)
        # per-column guard state: last segment's solver status code and
        # whether any fallback path touched the column (sticky until evict)
        self.status = np.zeros((self.width,), np.int32)
        self.degraded = np.zeros((self.width,), bool)

    @property
    def occupancy(self) -> int:
        return sum(r is not None for r in self.reqs)

    def free_slots(self) -> List[int]:
        return [j for j, r in enumerate(self.reqs) if r is None]

    def admit(self, reqs: List[SolveRequest],
              rows: Optional[torch.Tensor] = None) -> None:
        """Place requests into free slots (late arrivals join here — the
        restart-boundary admission of continuous batching).  ``rows``
        (``[len(reqs), n]``): this rank's rows of each request, where they
        travel apart from the requests (then ``req.b`` is not read)."""
        slots = self.free_slots()
        assert len(reqs) <= len(slots), (len(reqs), len(slots))
        for i, (j, req) in enumerate(zip(slots, reqs)):
            self.reqs[j] = req
            b = rows[i] if rows is not None else torch.as_tensor(
                req.b[self.row0:self.row0 + self.n], dtype=self.dtype)
            self.b[:, j] = b.to(self.b.device)
            self.x[:, j] = 0.0
            self.iters[j] = 0
            self.status[j] = 0
            self.degraded[j] = False

    def evict(self, j: int) -> SolveRequest:
        req = self.reqs[j]
        self.reqs[j] = None
        self.b[:, j] = 0.0
        self.x[:, j] = 0.0
        self.iters[j] = 0
        self.status[j] = 0
        self.degraded[j] = False
        return req

    def tightest_tol(self, default: float) -> float:
        tols = [r.tol for r in self.reqs if r is not None]
        return min(tols) if tols else default
