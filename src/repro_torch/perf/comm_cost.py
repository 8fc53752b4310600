"""Collective bytes of one run of a distributed function, the port's
counterpart of the reference's ``repro/perf/hlo_cost.py``.

The reference reads the collectives out of the partitioned HLO (result
shapes, loop-trip-corrected).  The port needs no parse: ``core.comm.Comm``
counts, per collective kind, the bytes each collective brought to this
rank over the wire, and ``collective_bytes`` reads the difference of those
counters around one run.  The kinds carry the reference's HLO names:
``all-gather``, ``collective-permute``, ``all-to-all``, and
``all-reduce`` for ``Comm.psum`` (an all-gather of the ``p - 1`` other
partials: the reference's ``(p - 1)x`` all-reduce wire factor).  The
counts are already wire bytes, so ``obs.metrics.wire_bytes`` is not
applied to them.
"""
from __future__ import annotations

from typing import Callable, Dict


def collective_bytes(fn: Callable, *args, comm) -> Dict[str, int]:
    """Per-kind bytes this rank received in one run of ``fn(*args)`` over
    ``comm`` (kinds that moved nothing are left out).  Every rank of the
    group must make the same call."""
    before = dict(comm.recv_by_kind)
    fn(*args)
    out = {k: v - before.get(k, 0) for k, v in comm.recv_by_kind.items()}
    return {k: v for k, v in out.items() if v}
