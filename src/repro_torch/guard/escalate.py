"""Escalation policies: status -> recovery ladder (guard pillar 3), port of
``repro/guard/escalate.py``.

``run_with_guards`` walks a ladder of named *rungs* (thunks producing a
solve-like result), accepts the first result that passes (converged,
every status OK), and counts every attempt / acceptance / rejection in
``GUARD_COUNTERS``.  The rung vocabulary the apps wire in:

- ``fp64-scalars`` -- the same solve with ``scalar_dtype=torch.float64``:
  the Krylov reductions accumulate in double while the vectors and the
  operator stay in working precision.  Torch needs no mode switch for it
  (the reference re-traces under ``enable_x64``), so :func:`fp64_scalars`
  only names the dtype;
- oversampling escalation -- :func:`construct_h2_certified` doubles the
  rangefinder budget until the operator certifies;
- ``loose`` -- a looser-tolerance solve as the last resort.

Counters are process-global and monotone; ``reset_guard_counters`` is for
tests.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .certify import Certificate, certify_h2, kernel_reference_apply
from .status import STATUS_OK, status_name, worst_status

GUARD_COUNTERS: collections.Counter = collections.Counter()


def reset_guard_counters() -> None:
    GUARD_COUNTERS.clear()


@contextlib.contextmanager
def fp64_scalars() -> Iterator[torch.dtype]:
    """Scope of the ``fp64-scalars`` rung: pass the yielded dtype as a
    solver's ``scalar_dtype`` and its reductions accumulate in double."""
    yield torch.float64


@dataclasses.dataclass
class GuardOutcome:
    """What the ladder did: the final result, which rung produced it, and
    the per-rung status trail."""
    result: Any
    rung: str
    attempts: List[Tuple[str, str]]      # (rung name, status/verdict name)
    ok: bool                             # some rung was accepted

    @property
    def recovered(self) -> bool:
        """True when a rung past the first was needed and succeeded."""
        return self.ok and len(self.attempts) > 1


def default_accept(result: Any) -> bool:
    """A solve-like result is acceptable when it converged and no guard
    tripped (objects without those fields pass vacuously)."""
    ok = True
    conv = getattr(result, "converged", None)
    if conv is not None:
        ok = ok and bool(np.all(torch.as_tensor(conv).cpu().numpy()))
    st = getattr(result, "status", None)
    if st is not None:
        ok = ok and worst_status(st) == STATUS_OK
    return ok


def run_with_guards(rungs: Sequence[Tuple[str, Callable[[], Any]]],
                    accept: Callable[[Any], bool] = default_accept
                    ) -> GuardOutcome:
    """Walk the recovery ladder; return the first accepted result.

    ``rungs``: ordered ``(name, thunk)`` pairs -- rung 0 is the primary
    attempt.  A thunk that raises counts as a rejected rung (the ladder
    continues).  When no rung is accepted the last result is returned with
    ``ok=False``; when the last rung raised, its exception is raised.
    """
    attempts: List[Tuple[str, str]] = []
    last: Any = None
    last_name = ""
    last_exc: Optional[BaseException] = None
    for i, (name, thunk) in enumerate(rungs):
        GUARD_COUNTERS[f"attempt/{name}"] += 1
        if i > 0:
            GUARD_COUNTERS["escalations"] += 1
        try:
            result = thunk()
        except Exception as e:            # noqa: BLE001 -- rung failure is data
            GUARD_COUNTERS[f"raise/{name}"] += 1
            attempts.append((name, f"raised:{type(e).__name__}"))
            last_exc, last, last_name = e, None, name
            continue
        last, last_name, last_exc = result, name, None
        verdict = status_name(getattr(result, "status", None))
        attempts.append((name, verdict))
        if verdict != "ok":
            GUARD_COUNTERS[f"status/{verdict}"] += 1
        if accept(result):
            GUARD_COUNTERS[f"accept/{name}"] += 1
            return GuardOutcome(result=result, rung=name, attempts=attempts,
                                ok=True)
        GUARD_COUNTERS[f"reject/{name}"] += 1
    GUARD_COUNTERS["exhausted"] += 1
    if last is None and last_exc is not None:
        raise last_exc
    return GuardOutcome(result=last, rung=last_name, attempts=attempts,
                        ok=False)


def construct_h2_certified(points: np.ndarray, kernel: Callable,
                           leaf_size: int, eta: float, *,
                           cert_tol: float = 1e-2, probes: int = 8,
                           max_rounds: int = 3, min_level: int = 1,
                           dtype=torch.float32, chunk: int = 1024,
                           sketch_opts: Optional[dict] = None,
                           device="cuda"):
    """Sketch-construct an H^2 operator on ``device``, certify it against
    ``kernel_reference_apply``, and escalate the rangefinder budget
    (oversampling, initial samples, rank cap doubled each round) until the
    stochastic error estimate passes ``cert_tol``.  The certificate runs
    the operator's HGEMV on the construction's ``backend`` (default
    ``"cuda"``).

    Returns ``(shape, data, tree, bs, cert, rounds)``; the last round's
    result is returned even when it fails certification (``cert.ok``
    tells).  Every escalation round is counted in ``GUARD_COUNTERS``.
    """
    from repro_torch.core.construction import construct_h2

    opts = dict(sketch_opts or {})
    ref = None
    cert: Optional[Certificate] = None
    out = None
    for rnd in range(max_rounds):
        out = construct_h2(points, kernel, leaf_size, cheb_p=0, eta=eta,
                           dtype=dtype, min_level=min_level,
                           method="sketch", sketch_opts=opts, device=device)
        shape, data, tree, _ = out
        if ref is None:
            ref = kernel_reference_apply(points, kernel, tree.perm, chunk,
                                         device=device)
        cert = certify_h2(shape, data, ref, probes=probes,
                          seed=int(opts.get("seed", 0)), tol=cert_tol,
                          backend=opts.get("backend", "cuda"))
        if cert.ok:
            if rnd > 0:
                GUARD_COUNTERS["construct/recovered"] += 1
            return (*out, cert, rnd + 1)
        GUARD_COUNTERS["construct/cert-failed"] += 1
        # double the rangefinder budget: more oversampling columns, more
        # initial samples, a higher rank cap (a starved cap can never
        # certify no matter how many probes confirm it)
        opts["oversample"] = 2 * int(opts.get("oversample", 10))
        opts["max_rank"] = 2 * int(opts.get("max_rank", 64))
        if opts.get("n_samples0"):
            opts["n_samples0"] = 2 * int(opts["n_samples0"])
    GUARD_COUNTERS["construct/exhausted"] += 1
    return (*out, cert, max_rounds)
