"""Phase annotation for profiles.

``phase("hgemv/upsweep")`` wraps a block in
``torch.profiler.record_function(name)``, which names the region in a
``torch.profiler`` trace (host range plus the device kernels launched under
it) and costs nothing measurable when no profiler is active.  Every phase
entered is recorded in ``PHASES_SEEN``, as in the reference.

Inside ``phase_times(sync)`` every phase also adds its host-clock time
(``sync()`` at entry and exit, so a phase's time includes the device work
it enqueued) to the returned dict: the per-phase breakdown of a
measurement run, not for timed runs themselves.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, Optional, Set

import torch

PHASES_SEEN: Set[str] = set()
_TIMES: Optional[Dict[str, float]] = None
_SYNC: Callable[[], None] = lambda: None


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Annotate the enclosed work as belonging to ``name``."""
    PHASES_SEEN.add(name)
    with torch.profiler.record_function(name):
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
