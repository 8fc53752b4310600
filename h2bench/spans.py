"""What the readers of the program's own spans share.

Two views of the same ``phase`` spans of ``repro_torch``:

- the traced window's (``h2bench/trace.py``): the count of a span over
  the window, the device time of the operations launched in it, and the
  idle time that began while it was the innermost span open; each read
  per call of the cell's span;
- the program's span totals (``repro_torch.obs.trace.span_totals()``),
  name -> (count, host seconds) over the whole process: the set-up's
  stages, which run before any trace.

A program without span totals is older than these spans and names none
of them, so every reader here reads None on it (and raises nothing: the
harness runs the readers on such a program too).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple


def _program_totals() -> Optional[Dict[str, Tuple[int, float]]]:
    from repro_torch.obs import trace
    read = getattr(trace, "span_totals", None)
    return read() if read is not None else None


def _calls(ctx) -> int:
    return ctx.trace.span(ctx.call_span).count if ctx.trace is not None \
        else 0


def count_per_call(ctx, span: str) -> Optional[float]:
    """Times ``span`` opened in the traced window, per call; 0 where the
    window has calls and the program, one that keeps span totals, opened
    it never."""
    calls = _calls(ctx)
    if not calls or _program_totals() is None:
        return None
    return ctx.trace.span(span).count / calls


def device_ms_per_call(ctx, span: str) -> Optional[float]:
    """Device milliseconds of the operations launched under ``span``, per
    call."""
    calls = _calls(ctx)
    st = ctx.trace.span(span) if calls else None
    if st is None or not st.ops:
        return None
    return st.device_s / calls * 1e3


def idle_ms_per_call(ctx, span: str) -> Optional[float]:
    """Idle milliseconds of the device that began with ``span`` the
    innermost host span open, per call."""
    calls = _calls(ctx)
    gaps = dict(ctx.trace.idle_gaps) if calls else {}
    if span not in gaps:
        return None
    return gaps[span] / calls * 1e3


def host_seconds(names: Sequence[str]) -> Optional[float]:
    """Host seconds inside the spans ``names`` over the process, summed
    over those entered; None where none was."""
    table = _program_totals() or {}
    found = [table[n] for n in names if n in table and table[n][0]]
    if not found:
        return None
    return sum(s for _, s in found)
