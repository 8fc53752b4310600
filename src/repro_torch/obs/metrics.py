"""Unified per-phase records: measured time x modeled flops x comm bytes
(the reference's ``repro/obs/metrics.py``).

One ``PhaseRecord`` joins, for a named phase of a (distributed) program:

  * measured wall time (``obs.timers`` segmented replay, microseconds);
  * modeled flops/bytes (``perf.op_cost.analyze`` on the stage function,
    plain backend).  **Flops are global**: with ``p > 1`` the ranks' counts
    are summed (one ``Comm.psum`` of the two numbers, outside any timed
    window); divide by ``p`` for per-device numbers;
  * modeled per-device collective bytes (the analytic comm models:
    ``core.dist.matvec_comm_bytes`` and friends, supplied by the caller);
  * *measured* per-device collective bytes (``perf.comm_cost`` around one
    run of the stage).  **Bytes are per device**: ``measured_comm_bytes``
    is this rank's wire bytes as ``Comm`` counted them, with no factor
    applied -- ``Comm`` already counts what crossed the wire.

``wire_bytes``/``_WIRE_FACTOR`` are the reference's normalization of HLO
*result* bytes to wire bytes (an all-gather's result holds all ``p``
slices of which ``p - 1`` crossed the wire; an all-reduce ring moves
``p - 1`` payloads).  The port keeps them for records that come from such
result sizes; its own measurements need no factor.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.perf import comm_cost, op_cost

# measured-result-bytes -> wire-bytes factor per collective kind, as a
# function of device count p (see module docstring)
_WIRE_FACTOR = {
    "all-gather": lambda p: (p - 1) / p,
    "reduce-scatter": lambda p: (p - 1) / p,
    "all-reduce": lambda p: float(p - 1),
    "all-to-all": lambda p: (p - 1) / p,
    "collective-permute": lambda p: 1.0,
}


@dataclasses.dataclass
class PhaseRecord:
    """One phase's joined measurement/model row (times in microseconds,
    byte fields per device, flops global)."""
    phase: str
    us: Optional[float] = None
    model_flops: Optional[float] = None
    model_bytes: Optional[float] = None             # unfused memory bound
    model_comm_bytes: Optional[float] = None        # analytic model
    measured_comm_bytes: Optional[float] = None     # Comm's wire bytes
    measured_comm_by_kind: Optional[Dict[str, float]] = None
    extra: Dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict:
        d = {k: v for k, v in dataclasses.asdict(self).items()
             if v not in (None, {}, [])}
        extra = d.pop("extra", {})
        d.update(extra)
        return d


def wire_bytes(by_kind: Dict[str, float], p: int) -> float:
    """Total wire bytes per device from per-kind collective RESULT bytes."""
    total = 0.0
    for kind, b in by_kind.items():
        total += b * _WIRE_FACTOR.get(kind, lambda _: 1.0)(p)
    return total


def measured_collective_bytes(fn: Callable, *args, comm) -> Dict[str, int]:
    """Per-collective-kind wire bytes this rank received in one run of
    ``fn(*args)`` over ``comm`` (``perf.comm_cost.collective_bytes``)."""
    return comm_cost.collective_bytes(fn, *args, comm=comm)


def phase_record(phase: str, us: Optional[float] = None,
                 fn: Optional[Callable] = None, args: tuple = (),
                 model_comm_bytes: Optional[float] = None,
                 p: int = 1, comm=None, **extra) -> PhaseRecord:
    """Build one record; when ``fn`` is given (a plain-backend function,
    see ``perf.op_cost``), derive the modeled flops and bytes from one run
    and, with ``comm``, the measured collective bytes from a second one.
    With ``p > 1`` every rank of ``comm`` must make the same call: the
    flop and byte models are summed over the ranks."""
    rec = PhaseRecord(phase=phase, us=us,
                      model_comm_bytes=model_comm_bytes, extra=extra)
    if fn is None:
        return rec
    cost = op_cost.analyze(fn, *args)
    if comm is not None:
        by_kind = measured_collective_bytes(fn, *args, comm=comm)
        rec.measured_comm_by_kind = by_kind
        rec.measured_comm_bytes = float(sum(by_kind.values()))
        if p > 1:
            dev = "cuda" if comm.backend == "nccl" else "cpu"
            tot = comm.psum(torch.tensor([cost["flops"], cost["bytes"]],
                                         dtype=torch.float64, device=dev))
            cost = {"flops": float(tot[0]), "bytes": float(tot[1])}
    rec.model_flops = cost["flops"]
    rec.model_bytes = cost["bytes"]
    return rec


def records_to_json(records: List[PhaseRecord], path: str, **header) -> None:
    """Serialize records (+ a header dict) as a JSON document."""
    doc = dict(header)
    doc["phases"] = [r.to_dict() for r in records]
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
