"""Open-loop Poisson load generator (DESIGN.md §9) -- the port's copy of
the reference's ``repro/serving/loadgen.py``: the same arrivals and
right-hand sides (numpy) from the same seed.

Open-loop means arrivals are scheduled by the process, not gated on
completions — the generator keeps offering work at the target rate even
while the service is slow, which is what exposes queueing collapse and
makes backpressure measurable (a closed-loop generator self-throttles and
hides it).  Inter-arrival gaps are Exp(rate) from a seeded generator, so a
drill's arrival schedule is a pure function of ``(seed, rate, n_requests)``
and the fault-free and faulty runs of a comparison see byte-identical
traffic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from repro_torch.serving.batching import SolveRequest


@dataclasses.dataclass
class PoissonLoad:
    """Deterministic open-loop request stream.

    ``rate``: mean arrivals per second (virtual time); ``n_requests``:
    stream length; ``deadline_s``: per-request relative deadline (None =
    no deadline); RHS are standard-normal ``[n]`` vectors drawn from the
    same seeded generator, so request ``rid`` carries the same payload in
    every run at this seed.
    """
    n: int
    rate: float
    n_requests: int
    tol: float = 1e-6
    deadline_s: Optional[float] = None
    seed: int = 0
    dtype: np.dtype = np.dtype(np.float32)

    def requests(self) -> List[SolveRequest]:
        rng = np.random.default_rng(self.seed)
        gaps = rng.exponential(1.0 / self.rate, size=self.n_requests)
        arrivals = np.cumsum(gaps)
        out: List[SolveRequest] = []
        for rid in range(self.n_requests):
            b = rng.standard_normal(self.n).astype(self.dtype)
            t = float(arrivals[rid])
            dl = math.inf if self.deadline_s is None else t + self.deadline_s
            out.append(SolveRequest(rid=rid, b=b, arrival=t, deadline=dl,
                                    tol=self.tol))
        return out
