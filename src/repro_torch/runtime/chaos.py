"""Deterministic chaos drills for the elastic distributed solve -- the
port's copy of the reference's ``repro/runtime/chaos.py`` (plain Python;
``summary()`` keys and values as the reference's).

A :class:`ChaosPlan` schedules the three fault classes of DESIGN.md §10
against a segmented Krylov solve, keyed by *segment index* (one segment =
K iterations between checkpoint boundaries), so every drill run injects
exactly the same faults at exactly the same iteration — the drill asserts
on deterministic quantities (convergence, iteration counts, which
checkpoint was restored), not on wall time:

  - **device loss**: raised *before* the segment runs (the dispatch never
    returns), forcing a shrink-remesh to the scheduled surviving device
    count and a checkpoint restore;
  - **NaN / silent corruption**: the segment's freshly computed state is
    poisoned *after* it returns, modeling in-flight memory corruption the
    recurrence itself cannot see — only the recomputed-residual tripwire
    catches it, triggering a rollback to the last valid checkpoint;
  - **straggler**: the observed segment duration is inflated; the
    ``StragglerMonitor`` must flag it while the solve proceeds unharmed
    (a straggler costs time, never iterations).

Each fault fires at most once even when its segment is re-run after a
restart (mirroring ``runtime.fault.FailureInjector``); the fired-state
lives on the plan, so build a fresh plan per drill.

:class:`ChaosReport` accumulates what the orchestrator observed — fault
events with recovery cost, per-segment and per-checkpoint wall times —
and derives the drill metrics recorded in ``BENCH_fault.json``
(time-to-recover, iterations lost per fault class, steady-state
checkpoint overhead as a fraction of segment wall time).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set


@dataclasses.dataclass
class ChaosPlan:
    """Fault schedule for one elastic solve, keyed by segment index."""
    device_loss_at: Dict[int, int] = dataclasses.field(default_factory=dict)
    nan_at: Set[int] = dataclasses.field(default_factory=set)
    straggle_at: Dict[int, float] = dataclasses.field(default_factory=dict)
    _fired: Set[str] = dataclasses.field(default_factory=set, repr=False)

    @classmethod
    def empty(cls) -> "ChaosPlan":
        return cls()

    def _once(self, kind: str, segment: int) -> bool:
        key = f"{kind}@{segment}"
        if key in self._fired:
            return False
        self._fired.add(key)
        return True

    def device_loss(self, segment: int) -> Optional[int]:
        """Surviving device count if a loss fires at this segment."""
        if segment in self.device_loss_at and \
                self._once("device-loss", segment):
            return self.device_loss_at[segment]
        return None

    def corrupts(self, segment: int) -> bool:
        return segment in self.nan_at and self._once("nan", segment)

    def straggle(self, segment: int) -> float:
        if segment in self.straggle_at and self._once("straggle", segment):
            return self.straggle_at[segment]
        return 0.0


@dataclasses.dataclass
class FaultEvent:
    """One observed fault + its recovery cost."""
    kind: str                 # "device-loss" | "corruption" | "straggler"
    segment: int              # segment index the fault fired at
    p_from: int               # device count before recovery
    p_to: int                 # device count after recovery
    iters_lost: int           # iterations re-run after the restore
    recover_s: float          # detection -> first state ready to resume


@dataclasses.dataclass
class ChaosReport:
    """What the orchestrator observed during one (possibly faulty) solve."""
    events: List[FaultEvent] = dataclasses.field(default_factory=list)
    restarts: int = 0
    segments_run: int = 0
    seg_wall_s: List[float] = dataclasses.field(default_factory=list)
    ckpt_save_s: List[float] = dataclasses.field(default_factory=list)
    straggler_flags: List[int] = dataclasses.field(default_factory=list)

    def checkpoint_overhead_pct(self) -> float:
        """Steady-state checkpoint cost as % of segment wall time
        (medians, so one cold save or one straggling segment cannot
        dominate)."""
        if not self.seg_wall_s or not self.ckpt_save_s:
            return 0.0
        seg = sorted(self.seg_wall_s)[len(self.seg_wall_s) // 2]
        sav = sorted(self.ckpt_save_s)[len(self.ckpt_save_s) // 2]
        return 100.0 * sav / seg if seg > 0 else 0.0

    def iters_lost(self, kind: Optional[str] = None) -> int:
        return sum(e.iters_lost for e in self.events
                   if kind is None or e.kind == kind)

    def summary(self) -> Dict:
        """Flat dict for BENCH_fault.json / drill assertions."""
        by_kind: Dict[str, Dict] = {}
        for e in self.events:
            d = by_kind.setdefault(e.kind, {"count": 0, "iters_lost": 0,
                                            "recover_s": 0.0})
            d["count"] += 1
            d["iters_lost"] += e.iters_lost
            d["recover_s"] = max(d["recover_s"], e.recover_s)
        return {
            "restarts": self.restarts,
            "segments_run": self.segments_run,
            "ckpt_overhead_pct": self.checkpoint_overhead_pct(),
            "straggler_flags": list(self.straggler_flags),
            "faults": by_kind,
        }
