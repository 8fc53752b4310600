"""Reduce a ``torch.profiler`` trace of a window to what the per-layer
readers take.

The profiler's Chrome trace names every host span (``record_function``:
the benchmark's ``h2bench/*`` spans and the program's ``phase`` ranges),
every CUDA runtime call and every device operation (kernels, copies,
fills); a device operation carries the correlation id of the runtime
call that launched it (a graph replay's operations that of its
``cudaGraphLaunch``).  An operation belongs to every span open on the
launching thread when its launch call ran.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "h2bench/window"
#: idle gaps shorter than this are counted together, unnamed: the card
#: passing from one operation to the next
MIN_GAP_US = 5.0
SHORT_GAP = "between operations (< 5 us)"


@dataclasses.dataclass
class SpanStat:
    count: int = 0            # times the span opened in the window
    device_s: float = 0.0     # device time of the operations launched in it
    ops: int = 0              # device operations launched in it


@dataclasses.dataclass
class TraceSummary:
    window_s: float                          # the traced window's length
    busy_s: float                            # device busy (union), in it
    spans: Dict[str, SpanStat]
    device_ops: List[Tuple[str, float]]      # top operations by device time
    idle_gaps: List[Tuple[str, float]]       # idle time by the host's span
    ops: int                                 # device operations in window

    def span(self, name: str) -> SpanStat:
        return self.spans.get(name, SpanStat())


def export_events(prof) -> List[dict]:
    """The trace's events, through a Chrome trace written under the
    temporary directory and removed at once."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class _Spans:
    """Host spans of one thread, to ask which were open at a time."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.by_name: Dict[str, Tuple[List[float], List[float]]] = {}
        for name in {s[2] for s in spans}:
            iv = sorted((a, b) for a, b, n in spans if n == name)
            self.by_name[name] = ([a for a, _ in iv], [b for _, b in iv])

    def open_at(self, t: float) -> List[str]:
        out = []
        for name, (starts, ends) in self.by_name.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ends[i] >= t:
                out.append(name)
        return out

    def innermost_at(self, t: float) -> str:
        best, width = "outside any span", float("inf")
        for name, (starts, ends) in self.by_name.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ends[i] >= t and ends[i] - starts[i] < width:
                best, width = name, ends[i] - starts[i]
        return best


def summarize(events: List[dict], top: int = 10) -> TraceSummary:
    """Reduce the events of a trace that holds one ``h2bench/window``
    span around the traced work (which ends in a synchronize)."""
    spans_by_tid: Dict[object, List[Tuple[float, float, str]]] = \
        defaultdict(list)
    launch: Dict[int, Tuple[object, float]] = {}
    device: List[dict] = []
    window = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat == "user_annotation":
            a, d = float(ev["ts"]), float(ev.get("dur", 0.0))
            spans_by_tid[ev.get("tid")].append((a, a + d, ev["name"]))
            if ev["name"] == WINDOW_SPAN:
                window = (a, a + d, ev.get("tid"))
        elif cat in RUNTIME_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (ev.get("tid"), float(ev["ts"]))
        elif cat in DEVICE_CATS:
            device.append(ev)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
    w0, w1, wtid = window
    spans = {tid: _Spans(s) for tid, s in spans_by_tid.items()}
    stats: Dict[str, SpanStat] = defaultdict(SpanStat)
    for a, b, name in spans_by_tid.get(wtid, []):
        if w0 <= a and b <= w1:
            stats[name].count += 1
    by_name: Dict[str, float] = defaultdict(float)
    iv, n_ops = [], 0
    owners: Dict[object, List[str]] = {}
    for ev in device:
        a, d = float(ev["ts"]), float(ev.get("dur", 0.0))
        if a + d < w0 or a > w1:
            continue
        n_ops += 1
        iv.append((max(a, w0), min(a + d, w1)))
        by_name[ev["name"][:160]] += d * 1e-6
        corr = ev.get("args", {}).get("correlation")
        if corr not in owners:
            src = launch.get(corr)
            owners[corr] = spans[src[0]].open_at(src[1]) \
                if src is not None and src[0] in spans else []
        for name in owners[corr]:
            st = stats[name]
            st.device_s += d * 1e-6
            st.ops += 1
    busy = _merge(iv)
    gaps: Dict[str, float] = defaultdict(float)
    host = spans.get(wtid)
    edges = [w0] + [t for ab in busy for t in ab] + [w1]
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b - a >= MIN_GAP_US and host is not None:
            gaps[host.innermost_at(a)] += (b - a) * 1e-6
        elif b > a:
            gaps[SHORT_GAP] += (b - a) * 1e-6
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        spans=dict(stats), device_ops=[list(x) for x in rank(by_name)],
        idle_gaps=[list(x) for x in rank(gaps)], ops=n_ops)


def traced_window(step: Callable[[], None], n: int, span: str
                  ) -> TraceSummary:
    """Run ``step`` ``n`` times on the card under the profiler, each inside
    the span ``span``, all inside ``h2bench/window``, which ends in a
    synchronize; returns the trace's summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            for _ in range(n):
                with record_function(span):
                    step()
            torch.cuda.synchronize()
    return summarize(export_events(prof))
