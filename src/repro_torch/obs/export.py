"""Chrome-trace / perfetto export of per-phase timelines (DESIGN.md §8),
the port's copy of the reference's ``repro/obs/export.py`` (pure JSON).

``chrome_trace`` lays the measured per-phase medians out as a synthetic
sequential timeline in the Chrome trace-event JSON format — load the file
at ``chrome://tracing`` or https://ui.perfetto.dev.  The timeline is
*reconstructed* from segmented-replay medians (one lane per variant, e.g.
halo-plan vs allgather), not captured live: it shows each phase's own cost
back-to-back, which is the quantity the overlap-restructuring work needs.
For a live capture use ``torch.profiler`` — the in-program
``obs.trace.phase`` annotations name the regions there too.
"""
from __future__ import annotations

import json
from typing import Dict, List, Mapping, Optional, Sequence


def chrome_trace_events(phase_us: Mapping[str, float], pid: int = 0,
                        tid: int = 0, t0_us: float = 0.0,
                        lane: str = "", iters: int = 1,
                        args: Optional[Mapping[str, Dict]] = None
                        ) -> List[Dict]:
    """Complete-event ("ph":"X") list for one lane of phases.

    ``phase_us`` maps phase name -> median microseconds; phases are laid
    end-to-end in dict order, repeated ``iters`` times (one repetition per
    solver iteration).  ``args`` optionally attaches per-phase payload
    dicts (model bytes, flops, ...) shown in the trace viewer.
    """
    events: List[Dict] = []
    if lane:
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": lane}})
    t = float(t0_us)
    for _ in range(max(iters, 1)):
        for name, us in phase_us.items():
            ev = {"name": name, "ph": "X", "ts": round(t, 3),
                  "dur": round(float(us), 3), "pid": pid, "tid": tid,
                  "cat": name.split("/")[0]}
            if args and name in args:
                ev["args"] = dict(args[name])
            events.append(ev)
            t += float(us)
    return events


def write_span_trace(path: str, spans: Sequence[Dict],
                     process: str = "repro_torch.serving virtual time") -> None:
    """Write explicitly-timestamped host-side spans as a Chrome trace.

    Unlike ``write_chrome_trace`` (which *reconstructs* a timeline from
    per-phase medians laid end-to-end), this exports spans that already
    carry their own placement — e.g. the serve loop's virtual-time stage
    spans (``{"name", "ts", "dur", "args"}`` with ts/dur in µs) — so queue
    wait, solve, backoff, and degraded time land where they actually
    happened.  Spans are binned into thread rows by name prefix (the part
    before the last ``/``) so each request stage gets its own lane.
    """
    lanes_seen: List[str] = []
    events: List[Dict] = [{"name": "process_name", "ph": "M", "pid": 0,
                           "args": {"name": process}}]
    for sp in spans:
        lane = sp["name"].rsplit("/", 1)[0] if "/" in sp["name"] \
            else sp["name"]
        if lane not in lanes_seen:
            lanes_seen.append(lane)
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": lanes_seen.index(lane),
                           "args": {"name": lane}})
        ev = {"name": sp["name"], "ph": "X", "ts": round(float(sp["ts"]), 3),
              "dur": round(float(sp["dur"]), 3), "pid": 0,
              "tid": lanes_seen.index(lane),
              "cat": sp["name"].split("/")[0]}
        if sp.get("args"):
            ev["args"] = dict(sp["args"])
        events.append(ev)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f,
                  indent=1)


def write_chrome_trace(path: str, lanes: Sequence[Dict]) -> None:
    """Write a trace file from lane dicts:
    ``{"lane": str, "phase_us": {...}, "iters": int, "args": {...}}``.
    Each lane becomes one thread row (tid = index)."""
    events: List[Dict] = [{"name": "process_name", "ph": "M", "pid": 0,
                           "args": {"name": "repro_torch.obs segmented replay"}}]
    for tid, ln in enumerate(lanes):
        events += chrome_trace_events(
            ln["phase_us"], pid=0, tid=tid, lane=ln.get("lane", f"lane{tid}"),
            iters=ln.get("iters", 1), args=ln.get("args"))
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms"}, f, indent=1)
