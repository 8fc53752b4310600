"""What the per-layer readers in ``metrics/`` share: a span's share of its
roofline, device operations per call, the device's idle share."""
from __future__ import annotations

import sys
from typing import Optional

from h2bench import work


def roofline_share(ctx, span: str) -> Optional[float]:
    """Percent of the roofline of the work ``ctx.work[span]`` (per call)
    done in the device time of the operations launched under ``span``,
    per call of the cell's own span; None where the trace saw none."""
    if ctx.trace is None or span not in ctx.work:
        return None
    calls = ctx.trace.span(ctx.call_span).count
    st = ctx.trace.span(span)
    if not calls or not st.ops or st.device_s <= 0:
        return None
    share, by = work.roofline(ctx.work[span], st.device_s / calls)
    print(f"roofline {span}: {share:.4f} % of the {by} bound "
          f"({st.device_s / calls:.6g} s a call, {st.ops / calls:g} device "
          f"operations a call; peaks {work.PEAKS})", file=sys.stderr)
    return share


def ops_per_call(ctx) -> Optional[float]:
    """Device operations launched under the cell's span, per call."""
    if ctx.trace is None:
        return None
    st = ctx.trace.span(ctx.call_span)
    return st.ops / st.count if st.count and st.ops else None


def idle_share(ctx) -> Optional[float]:
    """Percent of the traced window in which no device operation ran."""
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
