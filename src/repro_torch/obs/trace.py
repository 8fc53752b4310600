"""Phase annotation for profiles (the reference's ``repro/obs/trace.py``).

``phase("hgemv/upsweep")`` wraps a block in
``torch.profiler.record_function(name)`` while a profiler records on the
calling thread, which names the region in a ``torch.profiler`` trace (host
range plus the device kernels launched under it).  With no profiler
recording, the range is not opened: ``record_function`` would still cost
about 10 us of host time a phase, and a phase that closes right after a
device-to-host read (``compress/rank-pick``) sits on the host's critical
path while the card waits.

Every phase entered also adds to a process-wide table of span totals,
keyed by name: one to its count, and its host-clock duration
(``time.perf_counter()`` at entry and exit, with no synchronize).
``span_totals()`` returns a copy, name -> (count, seconds), and
``reset_span_totals()`` clears it; ``PHASES_SEEN`` is a live view of the
table's names (the reference's registry of phases entered).  This is the
view an operator has without a profiler.  The seconds are host time: a
span that ends while the device still has work queued does not include
that work, which lands in the first later span that waits for the
device (a host read, a synchronize, a pageable upload).

The annotation is neutral: it adds no device work and changes no result.
``record_function`` dispatches only the ``profiler::`` marks that open and
close its range; the ATen operations a function issues are the same with
tracing on and off, with a profiler and without (``tests/test_torch_obs.py`` records them with a
``TorchDispatchMode``), the counterpart of the reference's byte-equal
jaxprs.  The switch exists to prove that and as an escape hatch: set
``REPRO_OBS_DISABLE=1`` in the environment or call ``set_enabled(False)``;
while disabled, ``phase`` does nothing at all (no ``record_function``, no
span total, no ``phase_times``/``phase_events`` accounting).

Inside ``phase_times(sync)`` every phase also adds its host-clock time
(``sync()`` at entry and exit, so a phase's time includes the device work
it enqueued) to the returned dict: the per-phase breakdown of a
measurement run, not for timed runs themselves.  Inside ``phase_events()``
every phase instead records a CUDA event at entry and exit, without a
synchronize; the dict is filled with the milliseconds between them when
the block ends (a phase's time then includes any gap while the host
enqueues it, and a host sync inside the phase).
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd import _profiler_enabled

# name -> [count, host seconds]; cleared in place, so the view stays live
_TOTALS: Dict[str, List[float]] = {}
_TOTALS_LOCK = threading.Lock()
PHASES_SEEN = _TOTALS.keys()
_TIMES: Optional[Dict[str, float]] = None
_EVENTS: Optional[List[Tuple[str, object, object]]] = None
_SYNC: Callable[[], None] = lambda: None
_ENABLED = os.environ.get("REPRO_OBS_DISABLE", "0") != "1"
_NO_RANGE = contextlib.nullcontext()


def enabled() -> bool:
    return _ENABLED


def set_enabled(flag: bool) -> None:
    """Toggle annotation for every ``phase`` entered from now on."""
    global _ENABLED
    _ENABLED = bool(flag)


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Annotate the enclosed work as belonging to ``name`` (hierarchical
    slash-paths; nesting ``phase`` blocks nests the ranges)."""
    if not _ENABLED:
        yield
        return
    with _TOTALS_LOCK:
        total = _TOTALS.setdefault(name, [0, 0.0])
        total[0] += 1
    start = time.perf_counter()
    try:
        with (torch.profiler.record_function(name) if _profiler_enabled()
              else _NO_RANGE):
            if _EVENTS is not None:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                try:
                    yield
                finally:
                    ev[1].record()
                    _EVENTS.append((name, ev[0], ev[1]))
                return
            if _TIMES is None:
                yield
                return
            _SYNC()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                _SYNC()
                _TIMES[name] += (time.perf_counter() - t0) * 1e3
    finally:
        took = time.perf_counter() - start
        with _TOTALS_LOCK:   # to the entry taken at entry: a reset drops it
            total[1] += took


def span_totals() -> Dict[str, Tuple[int, float]]:
    """A copy of the span totals: name -> (times entered, host seconds
    inside), over every ``phase`` entered while tracing was enabled since
    the process started or ``reset_span_totals()``."""
    with _TOTALS_LOCK:
        return {k: (int(c), s) for k, (c, s) in _TOTALS.items()}


def reset_span_totals() -> None:
    """Clear the span totals (and so ``PHASES_SEEN``)."""
    with _TOTALS_LOCK:
        _TOTALS.clear()


def timing_active() -> bool:
    """Whether ``phase_times`` or ``phase_events`` is active (neither may
    be while a CUDA graph is captured: both act on the host at every
    phase)."""
    return _TIMES is not None or _EVENTS is not None


@contextlib.contextmanager
def phase_times(sync: Callable[[], None] = lambda: None
                ) -> Iterator[Dict[str, float]]:
    """Accumulate milliseconds per phase name while active."""
    global _TIMES, _SYNC
    _TIMES, _SYNC = defaultdict(float), sync
    try:
        yield _TIMES
    finally:
        _TIMES, _SYNC = None, (lambda: None)


@contextlib.contextmanager
def phase_events() -> Iterator[Dict[str, float]]:
    """Accumulate device milliseconds per phase name (CUDA events between
    a phase's entry and exit) while active; the dict is filled when the
    block ends."""
    global _EVENTS
    times: Dict[str, float] = defaultdict(float)
    _EVENTS = []
    try:
        yield times
        torch.cuda.synchronize()
        for name, a, b in _EVENTS:
            times[name] += a.elapsed_time(b)
    finally:
        _EVENTS = None


def annotate(name: str):
    """Decorator form: ``@annotate("hgemv/upsweep")`` wraps every call."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with phase(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco
