"""Stochastic a-posteriori certification of an operator apply (pillar 1b),
port of ``repro/guard/certify.py``.

The estimate is the randomized Frobenius test: for a Gaussian probe block
``Omega in R^{n x probes}``,

    ||A_test Omega - A_ref Omega||_F / ||A_ref Omega||_F

concentrates around the relative operator error.  Probes come from the
counter-based streams of ``sketch.rng`` on a dedicated stream id far above
the per-level construction streams, so a certificate is bit-reproducible
for a given ``(seed, n, probes)`` -- on the CPU and the card alike -- and
independent of how either apply is batched.  The bits are Philox's, not
the reference's threefry (``sketch.rng``).  Cost: ``probes`` columns of
each apply.

A NaN/Inf anywhere in the test apply surfaces as a non-finite estimate,
which fails the certificate.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.structure import H2Data, H2Shape
from repro_torch.obs.trace import phase
from repro_torch.sketch.rng import node_gaussians, stream_key

# probe stream id: construction streams are tree levels (0..depth ~ 30),
# keep certification probes on a disjoint counter stream
CERT_STREAM = 10_007


@dataclasses.dataclass
class Certificate:
    """Outcome of one stochastic certification."""
    rel_err: float          # estimated relative operator error (nan = broken)
    tol: float
    ok: bool
    probes: int
    seed: int
    n: int

    def __bool__(self) -> bool:
        return self.ok


def probe_block(n: int, probes: int, seed: int = 0, dtype=torch.float32,
                device="cuda") -> torch.Tensor:
    """The deterministic Gaussian probe block ``[n, probes]`` on
    ``device``."""
    ids = torch.zeros((1,), dtype=torch.int64, device=device)
    return node_gaussians(stream_key(seed, CERT_STREAM), ids, rows=n,
                          cols=probes, dtype=dtype)[0]


def certify_matvec(apply_test: Callable, apply_ref: Callable, n: int, *,
                   probes: int = 8, seed: int = 0, tol: float = 1e-3,
                   dtype=torch.float32, device="cuda") -> Certificate:
    """Estimate ``||A_test - A_ref|| / ||A_ref||`` from ``probes`` columns.

    Both applies take/return ``[n, nv]`` blocks on ``device``.  ``ok`` is
    False when the estimate exceeds ``tol`` *or* is non-finite.  The norms
    are taken in float64.
    """
    with phase("guard/certify"):
        om = probe_block(n, probes, seed, dtype, device)
        yt = torch.as_tensor(apply_test(om)).double()
        yr = torch.as_tensor(apply_ref(om)).double()
        den = torch.linalg.norm(yr)
        rel = torch.linalg.norm(yt - yr) / torch.where(den > 0, den, 1.0)
    rel = float(rel)
    return Certificate(rel_err=rel, tol=tol,
                       ok=bool(np.isfinite(rel) and rel <= tol),
                       probes=probes, seed=seed, n=n)


def kernel_reference_apply(points: np.ndarray, kernel: Callable,
                           perm: Optional[np.ndarray] = None,
                           chunk: int = 1024, device="cuda") -> Callable:
    """Reference ``x -> K x`` from the kernel itself, in row strips.

    ``kernel`` takes torch tensors (``core.kernels_fn``).  Each ``chunk x
    n`` strip is evaluated in float64 on ``device``, rounded to ``x``'s
    dtype and multiplied into ``x``, so the dense ``n x n`` matrix is never
    formed; with ``perm`` (``tree.perm``) the apply acts in tree order,
    matching a constructed H^2 operator.
    """
    p = points[perm] if perm is not None else points
    pts = torch.as_tensor(np.asarray(p), dtype=torch.float64, device=device)
    n = pts.shape[0]

    def apply(x):
        x = torch.as_tensor(x, device=device)
        outs = []
        for i0 in range(0, n, chunk):
            strip = kernel(pts[i0:i0 + chunk, None, :], pts[None, :, :])
            outs.append(strip.to(x.dtype) @ x)
        return torch.cat(outs, dim=0)

    return apply


def certify_h2(shape: H2Shape, data: H2Data, apply_ref: Callable, *,
               probes: int = 8, seed: int = 0, tol: float = 1e-3,
               backend: str = "cuda") -> Certificate:
    """Certify a constructed H^2 operator (its ``h2_matvec`` on
    ``backend``) against a reference apply, on the operator's device."""
    from repro_torch.core.matvec import h2_matvec
    return certify_matvec(
        lambda x: h2_matvec(shape, data, x, backend), apply_ref, shape.n,
        probes=probes, seed=seed, tol=tol, dtype=data.u_leaf.dtype,
        device=data.u_leaf.device)
