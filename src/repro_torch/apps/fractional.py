"""2D variable-diffusivity integral fractional diffusion solver (paper §6.4),
single device.

    L[u](x) = -2 int_{Omega u Omega_0} (u(y)-u(x)) a(x,y) / |y-x|^(2+2b) dy

discretized on a regular grid (paper Eq. 9):  h^2 (D + K + C) u = b, with
  K  -- the dense kernel matrix (zero diagonal), compressed as an H^2 matrix
       built by Chebyshev interpolation + algebraic recompression;
  D  -- diagonal, D_ii = (Khat @ 1)_i where Khat is the same (positive)
       kernel on the extended grid Omega u Omega_0 (paper Eq. 10) --
       assembled with a second H^2 operator and one HGEMV, then discarded;
  C  -- the leading-order regularization term gamma * (-div kappa grad)_h
       with gamma = h^(-2*beta), the reference's deviation from the full
       locally-corrected quadrature constants.

Solver: ``repro_torch.solvers`` -- PCG (or GMRES) run in fixed-length
segments, replayed from CUDA graphs on the card, preconditioned by
geometric-multigrid V-cycles on ``gamma*C + diag(D)``.

The distributed solve, the guard ladder (``solve_with_guards``) and the
elastic solve are not ported yet (ROADMAP Queue 1 items 2, 6 and 7).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.compression import compress
from repro_torch.core.construction import construct_h2
from repro_torch.core.kernels_fn import (diffusivity_2d, fractional_kernel_2d,
                                         fractional_kernel_2d_positive)
from repro_torch.core.matvec import h2_matvec
from repro_torch.guard.status import worst_status
from repro_torch.solvers import graphs
from repro_torch.solvers.krylov import gmres as _gmres
from repro_torch.solvers.krylov import pcg as _pcg
from repro_torch.solvers.mg import build_grid_mg, mg_precond_local


def interior_grid(n: int) -> np.ndarray:
    """n x n cell-centered grid on Omega = [-1, 1]^2."""
    h = 2.0 / n
    ax = -1.0 + h * (np.arange(n) + 0.5)
    xx, yy = np.meshgrid(ax, ax, indexing="ij")
    return np.stack([xx.ravel(), yy.ravel()], -1)


def extended_grid(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """3n x 3n grid on [-3, 3]^2 (same h); returns (points, interior mask)."""
    h = 2.0 / n
    ax = -3.0 + h * (np.arange(3 * n) + 0.5)
    xx, yy = np.meshgrid(ax, ax, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel()], -1)
    inside = (np.abs(pts[:, 0]) < 1.0) & (np.abs(pts[:, 1]) < 1.0)
    return pts, inside


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class FractionalProblem:
    n: int                       # grid side (interior)
    beta: float = 0.75
    h2_tol: float = 1e-6         # compression tolerance for K
    cheb_p: int = 6
    eta: float = 0.9
    construction: str = "cheb"   # only "cheb" is ported
    device: str = "cuda"
    backend: str = "cuda"        # kernels of the compress and the D HGEMV

    def build(self, compress_k: bool = True) -> Dict:
        """The operator's parts on ``device``.  ``timings`` holds the
        seconds of each part (synchronized on the card): ``construct_k``,
        ``compress``, ``construct_ext`` (the extended grid's operator),
        ``d_matvec`` (its one HGEMV)."""
        if self.construction == "sketch":
            raise NotImplementedError(
                "FractionalProblem(construction='sketch') is not ported yet "
                "(ROADMAP Queue 1 item 5: sketch construction)")
        if self.construction != "cheb":
            raise ValueError(f"unknown construction {self.construction!r}")
        n = self.n
        h = 2.0 / n
        dev = torch.device(self.device)
        timings: Dict[str, float] = {}

        def timed(name, fn):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn()
            _sync(dev)
            timings[name] = time.perf_counter() - t0
            return out

        pts = interior_grid(n)
        m = 16 if n <= 32 else 64
        shape, data, tree, _ = timed("construct_k", lambda: construct_h2(
            pts, fractional_kernel_2d(self.beta), leaf_size=m,
            cheb_p=self.cheb_p, eta=self.eta, device=dev))
        if compress_k:
            shape, data = timed("compress", lambda: compress(
                shape, data, tol=self.h2_tol, backend=self.backend))

        # --- D via Khat @ 1 on the extended grid (Eq. 10) ---
        pts_ext, inside = extended_grid(n)
        m_ext = 36 if (9 * n * n) % 36 == 0 else 16
        n_ext = pts_ext.shape[0]
        while n_ext % m_ext or ((n_ext // m_ext) & (n_ext // m_ext - 1)):
            m_ext *= 2
            if m_ext > n_ext:
                m_ext = n_ext
                break
        eshape, edata, etree, _ = timed("construct_ext", lambda: construct_h2(
            pts_ext, fractional_kernel_2d_positive(self.beta),
            leaf_size=m_ext, cheb_p=self.cheb_p, eta=self.eta, device=dev))
        ones = torch.ones((eshape.n, 1), dtype=torch.float32, device=dev)
        row_sums = timed("d_matvec", lambda: h2_matvec(
            eshape, edata, ones, backend=self.backend))[:, 0]
        del edata, ones                 # the extended operator is discarded
        # undo the tree permutation, restrict to Omega
        unperm = np.empty(eshape.n, np.int64)
        unperm[etree.perm] = np.arange(eshape.n)
        sel = torch.as_tensor(unperm[inside], device=dev)
        d_diag = row_sums[sel]                      # grid-ordered, Omega only

        # --- C: kappa-weighted 5-point Laplacian, gamma = h^(-2 beta) ---
        kappa = diffusivity_2d(torch.as_tensor(pts, dtype=torch.float64)
                               ).reshape(n, n)
        gamma = h ** (-2.0 * self.beta)

        # tree-order <-> grid-order maps for K
        perm = tree.perm
        unperm_k = np.empty(shape.n, np.int64)
        unperm_k[perm] = np.arange(shape.n)

        return {
            "shape": shape, "data": data, "perm": perm,
            "unperm": unperm_k, "d_diag": d_diag.contiguous(),
            "kappa": kappa.to(device=dev, dtype=torch.float32),
            "gamma": gamma, "h": h, "n": n, "timings": timings,
        }


def _edge_pad(k: torch.Tensor) -> torch.Tensor:
    k = torch.cat([k[:1], k, k[-1:]], dim=0)
    return torch.cat([k[:, :1], k, k[:, -1:]], dim=1)


def apply_c(u: torch.Tensor, kappa: torch.Tensor, h: float) -> torch.Tensor:
    """(-div kappa grad)_h u with zero Dirichlet (volume constraint) halo.
    u: [..., n, n] (a batch of grids), kappa: [n, n]."""
    up = F.pad(u, (1, 1, 1, 1))            # u = 0 outside Omega
    kp = _edge_pad(kappa)
    ke = 0.5 * (kp[1:-1, 1:-1] + kp[2:, 1:-1])      # south face
    kw = 0.5 * (kp[1:-1, 1:-1] + kp[:-2, 1:-1])
    kn = 0.5 * (kp[1:-1, 1:-1] + kp[1:-1, 2:])
    ks = 0.5 * (kp[1:-1, 1:-1] + kp[1:-1, :-2])
    c = up[..., 1:-1, 1:-1]
    lap = (ke * (up[..., 2:, 1:-1] - c) +
           kw * (up[..., :-2, 1:-1] - c) +
           kn * (up[..., 1:-1, 2:] - c) +
           ks * (up[..., 1:-1, :-2] - c))
    return -lap / (h * h)


def make_operator(prob: Dict, backend: str = "cuda"
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A u = h^2 (D + K + C) u; u in grid order [N] on the problem's
    device.  ``backend``: the HGEMV's (``"cuda"``: the kernels on CUDA
    tensors; ``"torch"``: plain PyTorch)."""
    shape, data = prob["shape"], prob["data"]
    d_diag, kappa = prob["d_diag"], prob["kappa"]
    gamma, h, n = prob["gamma"], prob["h"], prob["n"]
    perm_t = torch.as_tensor(prob["perm"], device=d_diag.device)
    unperm_t = torch.as_tensor(prob["unperm"], device=d_diag.device)

    def apply_a(u: torch.Tensor) -> torch.Tensor:
        ku = h2_matvec(shape, data, u[perm_t][:, None],
                       backend=backend)[:, 0][unperm_t]
        cu = apply_c(u.reshape(n, n), kappa, h).reshape(-1)
        return (h * h) * (d_diag * u + ku + gamma * cu)

    return apply_a


def make_preconditioner(prob: Dict, n_cycles: int = 2, nu: int = 3,
                        omega: float = 0.7, device="cuda"):
    """V-cycles on gamma*C + diag(D) (the local part of the operator), its
    level arrays on ``device``."""
    n = prob["n"]
    mg, arrs = build_grid_mg(prob["kappa"], prob["d_diag"].reshape(n, n),
                             prob["gamma"], prob["h"], n, p=1, nu=nu,
                             omega=omega, n_cycles=n_cycles, device=device)

    def precond(r: torch.Tensor) -> torch.Tensor:
        return mg_precond_local(mg, arrs, r)

    return precond


def solve(n: int, beta: float = 0.75, tol: float = 1e-8,
          h2_tol: float = 1e-6, use_precond: bool = True,
          construction: str = "cheb", method: str = "pcg",
          maxiter: int = 200, device="cuda", backend: str = "cuda",
          scalar_dtype=None, stag_window: int = 30, graph=None) -> Dict:
    """Build the problem on ``device`` and solve it.

    ``backend`` runs the compress and every HGEMV on the kernels
    (``"cuda"``) or plain PyTorch (``"torch"``); ``scalar_dtype`` (the fp64
    scalar rung) and ``stag_window`` are the PCG's; ``graph`` the
    solver's (default: CUDA graphs on the card).  Returns the solution
    ``u`` [n, n] (a tensor on ``device``), ``iters``, ``relres``,
    ``converged``, ``status``, the ``history``, the ``prob``, ``timings``
    (the build's parts, ``mg_build`` and ``solve``, seconds) and
    ``host_syncs`` (flags the solve read)."""
    if method not in ("pcg", "gmres"):
        raise ValueError(f"unknown method {method!r}")
    dev = torch.device(device)
    prob = FractionalProblem(n, beta=beta, h2_tol=h2_tol,
                             construction=construction, device=device,
                             backend=backend).build()
    timings = prob["timings"]
    apply_a = make_operator(prob, backend=backend)
    b = torch.ones((n * n,), dtype=torch.float32, device=dev) * \
        (2.0 / n) ** 2                                      # h^2 * 1
    _sync(dev)
    t0 = time.perf_counter()
    pre = make_preconditioner(prob, device=device) if use_precond else None
    _sync(dev)
    timings["mg_build"] = time.perf_counter() - t0
    syncs = graphs.HOST_SYNCS
    t0 = time.perf_counter()
    if method == "pcg":
        res = _pcg(apply_a, b, pre, tol=tol, maxiter=maxiter,
                   scalar_dtype=scalar_dtype, stag_window=stag_window,
                   graph=graph)
    else:
        res = _gmres(apply_a, b, pre, m=30, tol=tol, maxiter=maxiter,
                     graph=graph)
    _sync(dev)
    timings["solve"] = time.perf_counter() - t0
    return {"u": res.x.reshape(n, n), "iters": int(res.iters),
            "relres": float(res.relres), "converged": bool(res.converged),
            "status": worst_status(res.status), "history": res.res_history,
            "prob": prob, "timings": timings,
            "host_syncs": graphs.HOST_SYNCS - syncs}


def dense_reference_solution(n: int, beta: float = 0.75) -> np.ndarray:
    """O(N^2) exact assembly + direct solve on the CPU (float64), for
    validation at small n."""
    pts = interior_grid(n)
    h = 2.0 / n
    p = torch.as_tensor(pts, dtype=torch.float64)
    k_mat = fractional_kernel_2d(beta)(p[:, None, :], p[None, :, :]).numpy()
    pts_ext, inside = extended_grid(n)
    pe = torch.as_tensor(pts_ext, dtype=torch.float64)
    khat = fractional_kernel_2d_positive(beta)(pe[:, None, :], pe[None, :, :])
    d = khat.sum(dim=1).numpy()[inside]
    kappa = diffusivity_2d(p).reshape(n, n).to(torch.float32)
    gamma = h ** (-2.0 * beta)

    # dense C: apply_c (float32, as the operator) to every unit vector
    nn = n * n
    units = torch.eye(nn, dtype=torch.float32).reshape(nn, n, n)
    c_mat = apply_c(units, kappa, h).reshape(nn, nn).double().numpy().T
    a = (h * h) * (np.diag(d) + k_mat + gamma * c_mat)
    b = np.full(nn, h * h)
    return np.linalg.solve(a, b).reshape(n, n)
