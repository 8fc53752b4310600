"""Deterministic numerical-fault drills, port of ``repro/guard/drills.py``.

- :func:`drill_corrupt_operator` -- rewrite the largest coupling buffer
  the matvec reads, the silent-corruption case ``validate_h2`` (twin
  coherence) and ``certify_matvec`` must both catch before serving;
- :func:`drill_rank_starved` -- sketch-construction options starved far
  below the kernel's numerical rank, so certification fails and the
  oversampling escalation of ``construct_h2_certified`` has real work;
- :func:`drill_near_singular` -- a symmetric system with a controlled
  near-zero (or slightly negative) eigenvalue and an RHS aligned with its
  eigenvector: fp32 PCG trips INDEFINITE/STAGNATION instead of silently
  burning maxiter.

The two HGEMV backends read different coupling buffers: ``"torch"`` the
marshaled twins ``s_mar`` (the reference's single-dispatch matvec reads
only those), ``"cuda"`` the blocks ``s`` through the plan (``coupling_mv``
on S's natural layout).  Corrupting ``s_mar`` alone, as the reference
does, would leave the kernels' product healthy; so the drill corrupts the
buffer of the backend it is given.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.structure import H2Data


def drill_corrupt_operator(data: H2Data, *, mode: str = "scale",
                           magnitude: float = 32.0,
                           backend: str = "cuda") -> str:
    """Corrupt ``data``: rebind the list entry of the coupling buffer that
    ``backend``'s HGEMV reads at the level of the largest marshaled buffer
    (the reference's pick), leaving its twin as it was.  No tensor is
    written in place, so a shallow copy (``dataclasses.replace(data,
    s=list(data.s), s_mar=list(data.s_mar))``) keeps the healthy operator
    intact.  Returns a description of the injected fault.  ``mode``:
    ``"scale"`` multiplies the buffer by ``magnitude`` (finite corruption),
    ``"nan"`` poisons one entry.
    """
    if data.s_mar is None:
        raise ValueError("drill needs a marshaled operator (plan path)")
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    lvl = max(range(len(data.s_mar)), key=lambda l: data.s_mar[l].numel())
    if data.s_mar[lvl].numel() == 0:
        raise ValueError("no nonzero marshaled coupling level to corrupt")
    name = "s_mar" if backend == "torch" else "s"
    bufs = getattr(data, name)
    if mode == "nan":
        bad = bufs[lvl].clone()
        bad[0, 0, 0] = float("nan")
        bufs[lvl] = bad
        return f"{name}[{lvl}][0,0,0] <- nan"
    bufs[lvl] = bufs[lvl] * magnitude
    return f"{name}[{lvl}] *= {magnitude:g}"


def drill_rank_starved() -> dict:
    """Sketch options starved far below any smooth kernel's numerical
    rank: certification fails on round one, recovers under the doubling
    escalation of ``construct_h2_certified``."""
    return {"tol": 1e-6, "max_rank": 2, "oversample": 1, "n_samples0": 2,
            "seed": 0}


def drill_near_singular(n: int = 64, *, lam_min: float = -1e-3,
                        seed: int = 0, dtype=torch.float32, device="cuda"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric system ``(A, b)`` with eigenvalues
    ``{lam_min} U linspace(1, 10)`` and ``b`` dominated by the extreme
    eigenvector, built in numpy from ``seed`` (the reference's bits) and
    returned on ``device``.  ``lam_min < 0`` makes PCG's ``p^T A p`` go
    nonpositive (INDEFINITE); a tiny positive ``lam_min`` makes fp32 PCG
    stagnate at the rounding floor (STAGNATION).
    """
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([[lam_min], np.linspace(1.0, 10.0, n - 1)])
    a = (q * lam) @ q.T
    # RHS leaning on the extreme eigenvector, plus a broadband tail
    b = q[:, 0] + 1e-2 * rng.standard_normal(n)
    return (torch.as_tensor(a, device=device).to(dtype),
            torch.as_tensor(b, device=device).to(dtype))
