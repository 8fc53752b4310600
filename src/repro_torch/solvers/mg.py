"""Geometric-multigrid V-cycle preconditioner (the reference's
``repro/solvers/mg.py``), single device.

The GMG stand-in for the paper's AMG: a stencil V-cycle on
``gamma*C + diag(D)`` -- the 5-point kappa-weighted stencil with face
coefficients precomputed per level on the host, weighted-Jacobi smoothing,
full-weighting restriction and piecewise-constant prolongation, zero rows
and columns at the domain boundary (the volume constraint's Dirichlet
condition).  Every operation is a device-side tensor op with static
shapes, so a V-cycle is captured into the solver's CUDA graph whole.

Only ``p = 1`` is ported: the row-strip sharded V-cycle (``mg_specs``, the
halo exchanges, the deep-halo smoother, ``mg_halo_bytes``,
``solver_hide_flops``) belongs to the distributed solve.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.obs.trace import phase


@dataclasses.dataclass(frozen=True)
class GridMG:
    """Static V-cycle description (shapes, schedule, scalars)."""
    n: int
    levels: Tuple[int, ...]          # grid side per level (n, n/2, ..., 4)
    hs: Tuple[float, ...]
    gamma: float
    nu: int = 3
    omega: float = 0.7
    n_cycles: int = 2


@dataclasses.dataclass
class MGArrays:
    """Per-level stencil data, device tensors ``[n_l, n_l]``."""
    ke: List[torch.Tensor]           # face coefficients
    kw: List[torch.Tensor]
    kn: List[torch.Tensor]
    ks: List[torch.Tensor]
    dd: List[torch.Tensor]           # restricted diag(D)
    jd: List[torch.Tensor]           # Jacobi diagonal gamma*ksum/h^2 + dd


def _restrict_np(r: np.ndarray) -> np.ndarray:
    return 0.25 * (r[0::2, 0::2] + r[1::2, 0::2] + r[0::2, 1::2]
                   + r[1::2, 1::2])


def stencil_faces(k: np.ndarray):
    """Edge-padded face-averaged diffusivity coefficients of the 5-point
    ``-div kappa grad`` stencil (neighbor order: row+1, row-1, col+1,
    col-1)."""
    kp = np.pad(k, 1, mode="edge")
    ke = 0.5 * (kp[1:-1, 1:-1] + kp[2:, 1:-1])
    kw = 0.5 * (kp[1:-1, 1:-1] + kp[:-2, 1:-1])
    kn = 0.5 * (kp[1:-1, 1:-1] + kp[1:-1, 2:])
    ks = 0.5 * (kp[1:-1, 1:-1] + kp[1:-1, :-2])
    return ke, kw, kn, ks


def _host_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def build_grid_mg(kappa, d_diag, gamma: float, h0: float, n: int, p: int = 1,
                  nu: int = 3, omega: float = 0.7, n_cycles: int = 2,
                  device="cuda") -> Tuple[GridMG, MGArrays]:
    """Host-side pyramid build: restrict kappa/diag(D), precompute faces,
    then move every level to ``device``.

    ``kappa``/``d_diag``: [n, n] grid-order arrays (tensors or numpy).
    """
    if p > 1:
        raise NotImplementedError(
            "build_grid_mg(p > 1), the sharded V-cycle, is not ported yet "
            "(ROADMAP Queue 1 item 2: the distributed solve)")
    device = torch.device(device)
    k = _host_f32(kappa)
    d = _host_f32(d_diag)
    levels, hs = [], []
    arrs = MGArrays([], [], [], [], [], [])
    nn, hh = n, h0
    while nn >= 4:
        ke, kw, kn, ks = stencil_faces(k)
        jd = gamma * (ke + kw + kn + ks) / (hh * hh) + d
        for lst, a in zip((arrs.ke, arrs.kw, arrs.kn, arrs.ks, arrs.dd,
                           arrs.jd), (ke, kw, kn, ks, d, jd)):
            lst.append(torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                       device=device))
        levels.append(nn)
        hs.append(hh)
        k = _restrict_np(k)
        d = _restrict_np(d)
        nn //= 2
        hh *= 2
    mg = GridMG(n=n, levels=tuple(levels), hs=tuple(hs), gamma=gamma, nu=nu,
                omega=omega, n_cycles=n_cycles)
    return mg, arrs


# ---------------------------------------------------------------------------
# device-side V-cycle
# ---------------------------------------------------------------------------

def _apply_op(mg: GridMG, a: MGArrays, l: int, u: torch.Tensor
              ) -> torch.Tensor:
    """(gamma*C + diag(D)) u on level ``l`` (zero halo rows and columns)."""
    ue = F.pad(u, (0, 0, 1, 1))                       # rows halo
    uc = F.pad(u, (1, 1))                             # cols: Dirichlet
    h = mg.hs[l]
    lap = (a.ke[l] * (ue[2:] - u) + a.kw[l] * (ue[:-2] - u)
           + a.kn[l] * (uc[:, 2:] - u) + a.ks[l] * (uc[:, :-2] - u))
    return mg.gamma * (-lap / (h * h)) + a.dd[l] * u


def _smooth(mg: GridMG, a: MGArrays, l: int, u, b):
    for _ in range(mg.nu):
        r = b - _apply_op(mg, a, l, u)
        u = u + mg.omega * r / a.jd[l]
    return u


def _restrict(r):
    return 0.25 * (r[0::2, 0::2] + r[1::2, 0::2] + r[0::2, 1::2]
                   + r[1::2, 1::2])


def _prolong(e):
    n0, n1 = e.shape
    return e[:, None, :, None].expand(n0, 2, n1, 2).reshape(2 * n0, 2 * n1)


def _vcycle(mg: GridMG, a: MGArrays, l: int, b):
    # python recursion over static levels: each level's ops get their own
    # named scope ("mg/level0", "mg/level1", ...) in profiles
    with phase(f"mg/level{l}"):
        u = _smooth(mg, a, l, torch.zeros_like(b), b)
        if l + 1 < len(mg.levels):
            r = b - _apply_op(mg, a, l, u)
            rc = _restrict(r)
        else:
            return u
    e = _vcycle(mg, a, l + 1, rc)
    with phase(f"mg/level{l}"):
        u = u + _prolong(e)
        u = _smooth(mg, a, l, u, b)
    return u


def mg_precond_local(mg: GridMG, a: MGArrays, r: torch.Tensor
                     ) -> torch.Tensor:
    """Apply ``n_cycles`` V-cycles to the flat grid-order residual ``r``
    ([n*n]).  The incoming residual is scaled by ``1/h^2`` -- the
    preconditioner inverts the UNSCALED local operator
    ``gamma*C + diag(D)`` while the fractional system carries the paper's
    ``h^2`` prefactor."""
    with phase("precond/vcycle"):
        h0 = mg.hs[0]
        b = r.reshape(mg.n, mg.n) / (h0 * h0)
        u = torch.zeros_like(b)
        for _ in range(mg.n_cycles):
            u = u + _vcycle(mg, a, 0, b - _apply_op(mg, a, 0, u))
        return u.reshape(r.shape)
