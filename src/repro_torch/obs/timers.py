"""Opt-in phase timers (the reference's ``repro/obs/timers.py``).

The port's solve runs as eager PyTorch or as replayed CUDA graphs, and a
per-phase wall time cannot be read out of either without disturbing it.
This module gives the two sanctioned ways to measure one, both opt-in and
both leaving the default path untouched:

1. **Segmented replay** (``Stage``/``run_stages``/``time_stages``): the
   iteration is re-expressed as a pipeline of stage functions cut at
   registered phase boundaries (``obs.profile_solve`` builds the cut of
   the distributed fractional solve).  Each stage is warmed once, then
   timed with fixed inputs in interleaved rounds, every call synchronized
   on its device, median per stage.  Each timed stage runs inside
   ``record_function("obs.replay/<name>")``, so a ``torch.profiler``
   trace of a replay names its stages.

2. **Per-call stamps** (``IterationTimer``): a CUDA event (on the card)
   or a host clock stamp (on the CPU) recorded every time a wrapped
   function is called -- e.g. the solver's ``apply_a``, once per Krylov
   iteration.  The stamp is an extra operation on the stream, so this
   mode is not neutral (the reference's ``io_callback`` is not either):
   it is for ad-hoc investigation only, and it raises inside a CUDA graph
   capture, whose replays would not record it.

``time_fn`` / ``interleaved_times`` are the shared plain timers.  "Every
call synchronized on its device" means a ``torch.cuda.synchronize`` of
each card the call's result lives on; a result on the CPU has nothing to
wait for.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves


def block_until_ready(out):
    """Wait for the device work behind ``out``: synchronize every card one
    of its tensors lives on (a result that is no tensor tree, e.g. a
    dataclass, synchronizes the current card when CUDA is in use)."""
    leaves = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    for dev in {t.device for t in leaves if t.is_cuda}:
        torch.cuda.synchronize(dev)
    if not leaves and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out


def time_fn(fn: Callable, *args, reps: int = 10, warmup: int = 1) -> float:
    """Trimmed-mean seconds per call (drops min/max when reps > 2).

    The warmup call absorbs first-call costs (kernel builds, captures);
    every timed call is synchronized on its device.
    """
    for _ in range(max(warmup, 0)):
        block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return float(np.mean(ts[1:-1])) if len(ts) > 2 else float(np.mean(ts))


def interleaved_times(fns: Mapping[str, Callable], reps: int = 10,
                      warmup: int = 1,
                      before: Optional[Callable[[], None]] = None
                      ) -> Dict[str, List[float]]:
    """Round-robin timing of competing variants (comm modes, schedules).

    Within one round every variant sees the same machine state, so
    per-round ratios cancel the shared host's throughput drift -- take
    ``median_ratio`` of two entries for a drift-free speedup.
    ``before`` runs ahead of every timed call, outside its window (the
    ranks of a group start each program together after a barrier).
    """
    for fn in fns.values():
        for _ in range(max(warmup, 0)):
            block_until_ready(fn())
    acc: Dict[str, List[float]] = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            if before is not None:
                before()
            t0 = time.perf_counter()
            block_until_ready(fn())
            acc[name].append(time.perf_counter() - t0)
    return acc


def median_ratio(num: Sequence[float], den: Sequence[float]) -> float:
    """Median of per-round ratios num[i]/den[i] (drift-cancelling)."""
    return float(np.median([a / h for a, h in zip(num, den)]))


# ---------------------------------------------------------------------------
# segmented replay
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Stage:
    """One phase-boundary cut of a pipeline.

    ``fn`` is the stage function; ``inputs`` name entries of the
    environment dict fed positionally; ``outputs`` name where the results
    land (a single name binds the whole return value, several names unpack
    a top-level tuple).  ``phase`` is the phase name the stage's time is
    attributed to (defaults to ``name``).
    """
    name: str
    fn: Callable
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    phase: str = ""

    def __post_init__(self):
        if not self.phase:
            self.phase = self.name


def run_stages(stages: Sequence[Stage], env: Dict) -> Dict:
    """Execute the pipeline once, threading results through ``env``
    (mutated in place and returned).  Used to warm up and populate
    realistic stage inputs before timing."""
    for s in stages:
        out = block_until_ready(s.fn(*(env[k] for k in s.inputs)))
        if len(s.outputs) == 1:
            env[s.outputs[0]] = out
        else:
            if len(out) != len(s.outputs):
                raise ValueError(f"stage {s.name} returned {len(out)} "
                                 f"values for outputs {s.outputs}")
            env.update(zip(s.outputs, out))
    return env


def time_stages(stages: Sequence[Stage], env: Dict, reps: int = 8
                ) -> Dict[str, float]:
    """Median seconds per stage, interleaved rounds, fixed inputs.

    ``run_stages`` runs first (warmup and populating ``env``); inputs are
    NOT re-propagated between timed runs, so each stage sees identical
    operands every round.
    """
    run_stages(stages, env)
    acc: Dict[str, List[float]] = {s.name: [] for s in stages}
    for _ in range(reps):
        for s in stages:
            args = tuple(env[k] for k in s.inputs)
            with torch.profiler.record_function(f"obs.replay/{s.name}"):
                t0 = time.perf_counter()
                block_until_ready(s.fn(*args))
                acc[s.name].append(time.perf_counter() - t0)
    return {name: float(np.median(ts)) for name, ts in acc.items()}


# ---------------------------------------------------------------------------
# per-call stamps (opt-in; NOT neutral)
# ---------------------------------------------------------------------------

class IterationTimer:
    """Per-call stamps of a wrapped function.

    ``wrap(fn)`` returns a function that stamps before every call of
    ``fn``: a CUDA event recorded on the current stream when the first
    tensor argument is on a card, else ``time.perf_counter()``.
    ``intervals()`` gives the seconds between consecutive stamps (about
    one iteration each when ``fn`` runs once an iteration).
    """

    def __init__(self):
        self.stamps: List = []

    def reset(self) -> None:
        self.stamps = []

    def _stamp(self, args) -> None:
        t = next((a for a in args if isinstance(a, torch.Tensor)), None)
        if t is not None and t.is_cuda:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "IterationTimer inside a CUDA graph capture: the "
                    "replays would not record its events; time an eager "
                    "run")
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.stamps.append(ev)
        else:
            self.stamps.append(time.perf_counter())

    def wrap(self, fn: Callable) -> Callable:
        def wrapped(*args):
            self._stamp(args)
            return fn(*args)
        return wrapped

    def intervals(self) -> np.ndarray:
        """Seconds between consecutive stamps."""
        if self.stamps and isinstance(self.stamps[0], torch.cuda.Event):
            self.stamps[-1].synchronize()
            return np.asarray([a.elapsed_time(b) / 1e3 for a, b in
                               zip(self.stamps[:-1], self.stamps[1:])])
        return np.diff(np.asarray(self.stamps, np.float64))
