"""Fault tolerance: failure detection/injection, restart, straggler
mitigation, elastic re-scaling -- the port's copy of the reference's
``repro/runtime/fault.py`` (plain Python and numpy: the same jitter
stream, state transitions and restart budget, held to it by
``tests/test_torch_runtime.py``).

On a real multi-GPU deployment the failure signal comes from the runtime
(CUDA/NCCL errors, missing heartbeats).  Everything here is exercised on
CPU through injection hooks so the *logic* (restart from checkpoint, remesh,
straggler flagging) is tested end-to-end; the detection transport is the only
simulated part.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np


class StepFailure(RuntimeError):
    """Raised when a step is lost (device failure / preemption)."""


def backoff_delays(attempt: int, *, base: float = 0.05, factor: float = 2.0,
                   cap: float = 2.0, jitter: float = 0.5,
                   rng: Optional[np.random.Generator] = None) -> float:
    """Exponential backoff with multiplicative jitter: delay before retry
    ``attempt`` (0-based) is ``min(cap, base * factor**attempt)`` scaled by
    a uniform factor in ``[1 - jitter, 1 + jitter]``.  Pass a seeded ``rng``
    for deterministic drills (no rng -> no jitter, pure exponential)."""
    d = min(cap, base * factor ** attempt)
    if rng is not None and jitter > 0:
        d *= 1.0 + jitter * (2.0 * float(rng.uniform()) - 1.0)
    return d


@dataclasses.dataclass
class CircuitBreaker:
    """Closed -> open -> half-open -> closed breaker (cloud resilience
    pattern; DESIGN.md §9).  Single-threaded, driven by an external clock
    so drills are deterministic in virtual time.

    ``closed``: traffic flows; ``failure_threshold`` *consecutive* failures
    trip it ``open`` (callers must degrade — the breaker only decides).
    ``open``: primary path refused until ``cooldown`` elapses, after which
    ``allow`` transitions to ``half-open`` and admits ONE probe.
    ``half-open``: probe success re-closes; probe failure re-opens and
    restarts the cooldown.
    """
    failure_threshold: int = 3
    cooldown: float = 1.0
    state: str = "closed"
    consecutive_failures: int = 0
    opened_at: float = 0.0
    trips: int = 0
    recoveries: int = 0
    transitions: List[dict] = dataclasses.field(default_factory=list)

    def _goto(self, state: str, now: float) -> None:
        self.transitions.append({"t": now, "from": self.state, "to": state})
        self.state = state

    def allow(self, now: float) -> bool:
        """May the primary path be tried at time ``now``?"""
        if self.state == "closed":
            return True
        if self.state == "open":
            if now - self.opened_at >= self.cooldown:
                self._goto("half-open", now)
                return True
            return False
        return True     # half-open: the single in-flight probe

    def record_success(self, now: float) -> None:
        if self.state == "half-open":
            self.recoveries += 1
            self._goto("closed", now)
        self.consecutive_failures = 0

    def record_failure(self, now: float) -> None:
        self.consecutive_failures += 1
        if self.state == "half-open" or (
                self.state == "closed"
                and self.consecutive_failures >= self.failure_threshold):
            if self.state == "closed":
                self.trips += 1
            self._goto("open", now)
            self.opened_at = now


@dataclasses.dataclass
class FailureInjector:
    """Deterministically injects failures at given steps (tests/drills)."""
    fail_at: Dict[int, str] = dataclasses.field(default_factory=dict)
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise StepFailure(self.fail_at[step])


@dataclasses.dataclass
class StragglerMonitor:
    """EMA-based step-time watchdog (paper §4.2's overlap concern, turned
    into an operational signal).

    Flags steps slower than ``threshold`` x EMA.  On a real cluster the
    mitigation hook would trigger hot-spare swap / remesh; here it records
    the event and calls the callback.
    """
    ema_alpha: float = 0.1
    threshold: float = 2.0
    warmup: int = 3
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    ema: Optional[float] = None
    events: List[dict] = dataclasses.field(default_factory=list)
    _n: int = 0

    def record(self, step: int, seconds: float) -> bool:
        self._n += 1
        if self.ema is None:
            self.ema = seconds
            return False
        is_straggler = (self._n > self.warmup and
                        seconds > self.threshold * self.ema)
        if is_straggler:
            self.events.append({"step": step, "seconds": seconds,
                                "ema": self.ema})
            if self.on_straggler:
                self.on_straggler(step, seconds, self.ema)
        else:
            self.ema = (1 - self.ema_alpha) * self.ema + \
                self.ema_alpha * seconds
        return is_straggler


@dataclasses.dataclass
class ElasticPlan:
    """Recompute the run layout for a changed device count.

    The data pipeline is device-count independent (batch = f(seed, step)),
    params/optimizer restore with new shardings, so the only decisions are
    the new mesh shape and per-shard batch slice.
    """
    global_batch: int

    def remesh(self, n_devices: int, model_parallel: int):
        if n_devices % model_parallel:
            # degrade model parallelism to the largest divisor
            while n_devices % model_parallel:
                model_parallel //= 2
        data = n_devices // model_parallel
        assert self.global_batch % data == 0 or data % self.global_batch == 0,\
            f"global batch {self.global_batch} vs data shards {data}"
        return {"mesh_shape": (data, model_parallel),
                "axes": ("data", "model"),
                "per_shard_batch": max(1, self.global_batch // data)}


def run_with_restarts(step_fn: Callable[[int], None], *, start_step: int,
                      total_steps: int, max_restarts: int = 5,
                      on_restart: Optional[Callable[[int], int]] = None):
    """Restart loop: run step_fn(step); on StepFailure, call on_restart()
    (which restores from the last checkpoint and returns the resume step).

    ``max_restarts`` bounds *consecutive* restarts without forward
    progress: the budget resets whenever the run advances past the
    furthest step previously completed, so a long run with sporadic
    recoverable failures does not spuriously exhaust it — only a failure
    loop that stops making progress raises.

    Returns (steps_completed, restarts) with ``restarts`` the TOTAL
    restart count over the run.
    """
    restarts = 0
    budget_used = 0
    step = start_step
    furthest = start_step
    while step < total_steps:
        try:
            step_fn(step)
            step += 1
            if step > furthest:
                furthest = step
                budget_used = 0      # forward progress resets the budget
        except StepFailure:
            restarts += 1
            budget_used += 1
            if budget_used > max_restarts:
                raise
            step = on_restart(step) if on_restart else step
    return step, restarts
