"""2D variable-diffusivity integral fractional diffusion solver (paper §6.4),
on one device or over the ranks of a ``Comm``.

    L[u](x) = -2 int_{Omega u Omega_0} (u(y)-u(x)) a(x,y) / |y-x|^(2+2b) dy

discretized on a regular grid (paper Eq. 9):  h^2 (D + K + C) u = b, with
  K  -- the dense kernel matrix (zero diagonal), compressed as an H^2 matrix
       built by Chebyshev interpolation + algebraic recompression, or
       (``construction="sketch"``) by randomized sketching on the device,
       rank-adaptive to the tolerance and so not recompressed;
  D  -- diagonal, D_ii = (Khat @ 1)_i where Khat is the same (positive)
       kernel on the extended grid Omega u Omega_0 (paper Eq. 10) --
       assembled with a second H^2 operator and one HGEMV, then discarded;
  C  -- the leading-order regularization term gamma * (-div kappa grad)_h
       with gamma = h^(-2*beta), the reference's deviation from the full
       locally-corrected quadrature constants.

Solver: ``repro_torch.solvers`` -- PCG (or GMRES) run in fixed-length
segments, replayed from CUDA graphs on the card, preconditioned by
geometric-multigrid V-cycles on ``gamma*C + diag(D)``.

Distributed (``build_dist_problem``, ``make_dist_solve``,
``solve_distributed``): the operator is partitioned into ``p`` block rows
and the grid into ``p`` row strips; each rank runs the whole iteration on
its strip -- the H^2 matvec in tree order between two grid<->tree
transpositions, the sharded stencil, the sharded V-cycle and ``psum`` dot
products -- over a ``Comm``, its segments eagerly.  ``fused`` (DESIGN.md
§12) makes each transposition one plan-compressed all-to-all with the
stencil's row halo riding the inbound lanes, merges the H^2 exchange into
one all-to-all and smooths the V-cycle on deep halos;
``dist_solve_comm_bytes`` models the bytes a rank receives per iteration.

``solve_with_guards`` runs ``solve`` through the guard escalation ladder
(``repro_torch.guard``).

Elastic (DESIGN.md §10; ``make_dist_solve_segment``,
``solve_elastic_local``, ``solve_distributed_elastic``): the distributed
PCG in checkpointed segments over a ``Comm``, one process per rank.
Every control decision comes from replicated values (psum'd scalars, the
shared checkpoint directory after a barrier), so no rank branches alone.
A scheduled loss to ``p'`` ranks makes every world rank call
``torch.distributed.new_group(range(p'))`` in schedule order; ranks
``>= p'`` play the lost devices (they make the later losses' group calls
too and return a record of the segment they were lost at), and the
survivors re-shard their stacked copy of the operator with
``core.repartition.repartition_h2`` and restore the last checkpoint.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.comm import Comm
from repro_torch.core.compression import compress
from repro_torch.core.construction import construct_h2
from repro_torch.core.dist import (DistH2Shape, _shard,
                                   dist_h2_matvec_local, local_shard,
                                   matvec_comm_bytes, merged_exchange_bytes,
                                   partition_h2)
from repro_torch.core.halo import (build_transpose_plan, transpose_a2a,
                                   transpose_pack)
from repro_torch.core.kernels_fn import (diffusivity_2d, fractional_kernel_2d,
                                         fractional_kernel_2d_positive)
from repro_torch.core.matvec import h2_matvec
from repro_torch.core.repartition import repartition_h2
from repro_torch.guard.escalate import (GUARD_COUNTERS, fp64_scalars,
                                        run_with_guards)
from repro_torch.guard.status import worst_status
from repro_torch.kernels import ops as kops
from repro_torch.obs.trace import phase
from repro_torch.runtime.chaos import ChaosPlan, ChaosReport, FaultEvent
from repro_torch.runtime.fault import (StepFailure, StragglerMonitor,
                                       run_with_restarts)
from repro_torch.solvers import graphs
from repro_torch.solvers.krylov import PCGState, _norm, pcg_init, \
    pcg_segment
from repro_torch.solvers.krylov import gmres as _gmres
from repro_torch.solvers.krylov import pcg as _pcg
from repro_torch.solvers.mg import (_apply_op as _mg_apply_op,
                                    build_grid_mg, mg_halo_bytes,
                                    mg_local_shard, mg_precond_local,
                                    solver_hide_flops)


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
    construction: str = "cheb"   # "cheb" (host) | "sketch" (device)
    device: str = "cuda"
    backend: str = "cuda"        # kernels of the compress, the sketch's
                                 # QR/SVD and the D HGEMV

    def _construct(self, pts, kernel, m):
        """One kernel-matrix construction, host-Chebyshev or device-sketch.

        Returns ``(construct_h2's tuple, needs_compress)``: the sketch path
        is already rank-adaptive (its rangefinder truncates to tolerance),
        so it needs no separate recompression pass; float32 sketching
        floors the tolerance at 1e-4."""
        if self.construction == "sketch":
            tol = max(self.h2_tol, 1e-4)
            return construct_h2(
                pts, kernel, leaf_size=m, cheb_p=self.cheb_p, eta=self.eta,
                method="sketch", device=self.device,
                sketch_opts={"tol": tol, "backend": self.backend}), False
        if self.construction != "cheb":
            raise ValueError(f"unknown construction {self.construction!r}")
        return construct_h2(pts, kernel, leaf_size=m, cheb_p=self.cheb_p,
                            eta=self.eta, device=self.device), True

    def build(self, compress_k: bool = True) -> Dict:
        """The operator's parts on ``device``.  ``timings`` holds the
        seconds of each part (synchronized on the card): ``construct_k``,
        ``compress`` (cheb only), ``construct_ext`` (the extended grid's
        operator), ``d_matvec`` (its one HGEMV)."""
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
        (shape, data, tree, _), needs_compress = timed(
            "construct_k", lambda: self._construct(
                pts, fractional_kernel_2d(self.beta), m))
        if compress_k and needs_compress:
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
        (eshape, edata, etree, _), _ = timed(
            "construct_ext", lambda: self._construct(
                pts_ext, fractional_kernel_2d_positive(self.beta), m_ext))
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


def pcg(apply_a, b, precond=None, tol=1e-8, maxiter=200):
    """Deprecated shim over ``repro_torch.solvers.pcg`` -- returns the
    legacy ``(x, iters, relres)`` tuple.  ``tol`` is relative to
    ``||b||``."""
    warnings.warn("apps.fractional.pcg is deprecated; use "
                  "repro_torch.solvers.pcg", DeprecationWarning, stacklevel=2)
    res = _pcg(apply_a, b, precond, tol=tol, maxiter=maxiter)
    return res.x, int(res.iters), float(res.relres)


def _setup(n: int, beta: float, h2_tol: float, use_precond: bool,
           construction: str, device, backend: str) -> Tuple:
    """The problem, operator, right-hand side and preconditioner of a
    solve on ``device``; ``timings`` gains ``mg_build``."""
    dev = torch.device(device)
    prob = FractionalProblem(n, beta=beta, h2_tol=h2_tol,
                             construction=construction, device=device,
                             backend=backend).build()
    apply_a = make_operator(prob, backend=backend)
    b = torch.ones((n * n,), dtype=torch.float32, device=dev) * \
        (2.0 / n) ** 2                                      # h^2 * 1
    _sync(dev)
    t0 = time.perf_counter()
    pre = make_preconditioner(prob, device=device) if use_precond else None
    _sync(dev)
    prob["timings"]["mg_build"] = time.perf_counter() - t0
    return prob, apply_a, b, pre


def _result(res, n: int, prob: Dict) -> Dict:
    return {"u": res.x.reshape(n, n), "iters": int(res.iters),
            "relres": float(res.relres), "converged": bool(res.converged),
            "status": worst_status(res.status), "history": res.res_history,
            "prob": prob, "timings": prob["timings"]}


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
    prob, apply_a, b, pre = _setup(n, beta, h2_tol, use_precond,
                                   construction, device, backend)
    syncs = graphs.HOST_SYNCS
    t0 = time.perf_counter()
    if method == "pcg":
        res = _pcg(apply_a, b, pre, tol=tol, maxiter=maxiter,
                   scalar_dtype=scalar_dtype, stag_window=stag_window,
                   graph=graph)
    else:
        res = _gmres(apply_a, b, pre, m=30, tol=tol, maxiter=maxiter,
                     graph=graph)
    _sync(b.device)
    prob["timings"]["solve"] = time.perf_counter() - t0
    return {**_result(res, n, prob),
            "host_syncs": graphs.HOST_SYNCS - syncs}


def solve_with_guards(n: int, beta: float = 0.75, tol: float = 1e-8,
                      h2_tol: float = 1e-6, use_precond: bool = True,
                      construction: str = "cheb", maxiter: int = 200,
                      loose_tol: Optional[float] = None, device="cuda",
                      backend: str = "cuda", stag_window: int = 30,
                      graph=None) -> Dict:
    """``solve`` through the guard escalation ladder (DESIGN.md §11).

    Rungs: (1) the primary PCG; (2) the same PCG with float64 scalar
    accumulation (recovers dot-product-rounding stagnation); (3) GMRES(30)
    at ``loose_tol`` (default ``100 * tol``) as the last resort.
    ``device``, ``backend``, ``stag_window`` (the PCG rungs') and ``graph``
    are ``solve``'s, passed to every rung.  The returned dict is
    ``solve``'s plus the ladder outcome (``rung``, ``attempts``,
    ``recovered``, ``guard_ok``) and ``rungs``: for each rung walked, its
    ``seconds`` (a CUDA graph's capture included) and, unless it raised,
    its ``iters``, ``relres`` and ``status``.
    """
    prob, apply_a, b, pre = _setup(n, beta, h2_tol, use_precond,
                                   construction, device, backend)
    rungs: Dict[str, Dict] = {}

    def timed(name, fn):
        def rung():
            rungs[name] = {}
            t0 = time.perf_counter()
            try:
                res = fn()
                _sync(b.device)
            finally:
                rungs[name]["seconds"] = time.perf_counter() - t0
            rungs[name].update(iters=int(res.iters),
                               relres=float(res.relres),
                               status=worst_status(res.status))
            return res
        return name, rung

    def primary():
        return _pcg(apply_a, b, pre, tol=tol, maxiter=maxiter,
                    stag_window=stag_window, graph=graph)

    def fp64_rung():
        with fp64_scalars() as sdt:
            return _pcg(apply_a, b, pre, tol=tol, maxiter=maxiter,
                        scalar_dtype=sdt, stag_window=stag_window,
                        graph=graph)

    def loose_rung():
        lt = loose_tol if loose_tol is not None else 100.0 * tol
        return _gmres(apply_a, b, pre, m=30, tol=lt, maxiter=maxiter,
                      graph=graph)

    out = run_with_guards([timed("primary", primary),
                           timed("fp64-scalars", fp64_rung),
                           timed("gmres-loose", loose_rung)])
    return {**_result(out.result, n, prob), "rung": out.rung,
            "attempts": out.attempts, "recovered": out.recovered,
            "guard_ok": out.ok, "rungs": rungs}


# ----------------------------------------------------------------------
# distributed solve (paper §6.4): every rank runs the whole iteration on
# its strip -- H^2 matvec, sharded stencil, sharded V-cycle, psum dots
# ----------------------------------------------------------------------

def build_dist_problem(prob: Dict, p: int, n_cycles: int = 2, nu: int = 3,
                       omega: float = 0.7, device="cuda", dist_source=None):
    """Partition the fractional operator for ``p`` block rows on
    ``device``.

    Returns ``(dshape, mg, args)`` with ``args = (ddata, aux, mg_arrays)``
    stacked for all ranks (``local_args`` cuts a rank's views).  ``aux``
    carries the grid<->tree transposition maps, sharded in row strips like
    the solver state: ``perm``/``unperm`` and, for ``p > 1``, the
    all-to-all plans of both transpositions.  The operator's local part
    ``D + gamma*C`` reuses the V-cycle's level-0 stencil arrays.

    ``dist_source``: optional ``(dshape_old, ddata_old)`` of an existing
    stacked partition -- the elastic remesh path re-shards it via
    ``core.repartition.repartition_h2`` instead of partitioning the
    single-device operator afresh (``prob`` then needs only the grid
    arrays ``kappa``, ``d_diag``, ``perm``, ``unperm``, ``gamma``, ``h``,
    ``n``).  A source already at ``p`` ranks is used as it is (re-sharding
    it would reproduce it bit for bit).
    """
    n = prob["n"]
    if dist_source is not None:
        dshape, ddata = dist_source if dist_source[0].p == p else \
            repartition_h2(dist_source[0], dist_source[1], p, device=device)
    else:
        dshape, ddata = partition_h2(prob["shape"], prob["data"], p,
                                     device=device)
    mg, mga = build_grid_mg(prob["kappa"], prob["d_diag"].reshape(n, n),
                            prob["gamma"], prob["h"], n, p=p, nu=nu,
                            omega=omega, n_cycles=n_cycles, device=device)
    if p > 1 and not mg.sharded(0):
        # power-of-two N = leaf*2^depth and p | n already imply
        # n % 2p == 0 for every partitionable configuration
        raise ValueError(f"grid side {n} too small to strip-shard over "
                         f"p={p} ranks (n % 2p != 0)")

    def i32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32,
                               device=device)

    aux = {"perm": i32(prob["perm"]), "unperm": i32(prob["unperm"])}
    if p > 1:
        # all_to_all transposition plans of the fused iteration: each rank
        # ships only the rows its peers need (vs the (p-1)*nloc rows of
        # the all_gather two-step path); the C-stencil row halo rides the
        # inbound round as extra lanes
        _, tin_send, tin_take = build_transpose_plan(prob["perm"], p)
        _, tout_send, tout_take = build_transpose_plan(prob["unperm"], p)
        aux.update(tin_send=i32(tin_send), tin_take=i32(tin_take),
                   tout_send=i32(tout_send), tout_take=i32(tout_take))
    return dshape, mg, (ddata, aux, mga)


def local_args(dshape: DistH2Shape, mg, args, rank: int):
    """Rank ``rank``'s views of ``build_dist_problem``'s stacked ``args``
    (no copies): its operator shard, its strips of the transposition maps
    (``[p, cap]`` send plans) and its V-cycle strips."""
    ddata, aux, mga = args
    return (local_shard(dshape, ddata, rank),
            {k: _shard(v, rank, dshape.p) for k, v in aux.items()},
            mg_local_shard(mg, mga, rank))


def _dist_apply_a(dshape: DistH2Shape, d, aux: Dict, mg, mga,
                  x: torch.Tensor, comm: Comm, mode: str, n: int, h: float,
                  schedule: str = "auto", backend: str = "cuda",
                  fused: bool = False, hide: int = 0,
                  tables: Optional[dict] = None,
                  packs: Optional[tuple] = None) -> torch.Tensor:
    """One rank's A u = h^2 (D + K + C) u; ``x``: its grid-order strip.

    The H^2 kernel works in tree order: the grid<->tree transpositions
    cross ranks.  Two-step (``fused=False``): one all_gather + local take
    each way, and the stencil's one-row halo by two permutes.  Fused
    (DESIGN.md §12): each transposition is ONE all-to-all on its plan
    (``core.halo.build_transpose_plan``) shipping only the rows peers
    reference, and the C-stencil's row halo rides the inbound round as
    extra lanes, so the local term needs no collective of its own; ``hide
    > 0`` also lowers the H^2 exchange to its merged single round.
    ``tables`` caches the H^2 exchange's pack tables across calls,
    ``packs`` holds the two transpositions' (``transpose_pack``; built
    at each call when not given).
    """
    p, me = dshape.p, comm.rank
    if fused and p > 1:
        rows = n // p
        x2d = x.reshape(rows, n)
        with phase("solve/transpose-in"):
            # lane r of the extra rows lands at rank r: our LAST row feeds
            # rank me+1's top halo, our FIRST row rank me-1's bottom halo
            extra = x.new_zeros((p, n))
            if me + 1 < p:
                extra[me + 1] = x2d[-1]
            if me >= 1:
                extra[me - 1] = x2d[0]
            tin, tout = packs if packs is not None else (None, None)
            xt, ex = transpose_a2a(x, aux["tin_send"], aux["tin_take"],
                                   comm, extra=extra, backend=backend,
                                   pack=tin)
        ku_t = dist_h2_matvec_local(dshape, d, xt[:, None], comm, mode,
                                    backend, schedule, hide, tables)[:, 0]
        with phase("solve/transpose-out"):
            ku, _ = transpose_a2a(ku_t, aux["tout_send"], aux["tout_take"],
                                  comm, backend=backend, pack=tout)
        with phase("solve/stencil"):
            zero = x.new_zeros((1, n))
            top = ex[me - 1:me] if me >= 1 else zero
            bot = ex[me + 1:me + 2] if me <= p - 2 else zero
            local = _mg_apply_op(mg, mga, 0, x2d, comm,
                                 halo=(top, bot)).reshape(x.shape)
            return (h * h) * (ku + local)
    with phase("solve/transpose-in"):
        xf = comm.all_gather(x) if p > 1 else x
        xt = xf.index_select(0, aux["perm"])[:, None]
    ku_t = dist_h2_matvec_local(dshape, d, xt, comm, mode, backend,
                                schedule, 0, tables)[:, 0]
    with phase("solve/transpose-out"):
        kf = comm.all_gather(ku_t) if p > 1 else ku_t
        ku = kf.index_select(0, aux["unperm"])
    with phase("solve/stencil"):
        u = x.reshape(n // p, n)
        local = _mg_apply_op(mg, mga, 0, u, comm).reshape(x.shape)
        return (h * h) * (ku + local)


def _fused_default(fused: Optional[bool], mode: str) -> bool:
    """Fused iteration default: on for the halo-plan comm modes (whose
    merged lowering it completes), off for the allgather/ppermute
    baselines -- forceable either way."""
    return mode.startswith("halo-plan") if fused is None else bool(fused)


def make_dist_solve_local(dshape: DistH2Shape, mg, args, comm: Comm, n: int,
                          h: float, method: str = "pcg",
                          mode: str = "halo-plan", tol: float = 1e-8,
                          maxiter: int = 200, use_precond: bool = True,
                          restart: int = 30, schedule: str = "auto",
                          backend: str = "cuda",
                          fused: Optional[bool] = None,
                          stag_window: int = 30) -> Dict:
    """One rank's solve on its ``args`` (``local_args`` of
    ``build_dist_problem``), for an ``n x n`` grid of spacing ``h``.

    Returns ``{"fn", "apply_a", "precond", "fused", "hide", "tcaps"}``:
    ``fn(b) -> SolveResult`` with ``b`` the rank's grid-order strip
    (``[n*n/p]``); ``apply_a``/``precond`` the rank's operator and
    preconditioner (``precond`` None without ``use_precond``).  ``fused``
    selects the DESIGN.md §12 iteration schedule (default: on for the
    halo-plan comm modes); ``schedule``/``backend`` thread through to the
    H^2 matvec (``core.dist``).  The dict also carries what ``apply_a``
    was built from -- ``dshape``, ``mg``, ``args``, ``n``, ``h``,
    ``mode``, ``schedule``, ``backend`` and ``packs`` (the two
    transpositions' pack tables, None unless fused) -- which
    ``obs.profile_solve`` cuts into stages.
    """
    if method not in ("pcg", "gmres"):
        raise ValueError(f"unknown method {method!r}")
    d, aux, mga = args
    fused = _fused_default(fused, mode)
    hide = solver_hide_flops(mg) if fused else 0
    bf16 = mode.endswith("-bf16")
    tables: dict = {}
    packs = (transpose_pack(aux["tin_send"], n),
             transpose_pack(aux["tout_send"])) \
        if fused and dshape.p > 1 else None

    def apply_a(x: torch.Tensor) -> torch.Tensor:
        return _dist_apply_a(dshape, d, aux, mg, mga, x, comm, mode, n, h,
                             schedule, backend, fused, hide, tables, packs)

    def precond(r: torch.Tensor) -> torch.Tensor:
        return mg_precond_local(mg, mga, r, comm, fused=fused, bf16=bf16)

    pre = precond if use_precond else None

    def fn(b: torch.Tensor):
        if method == "pcg":
            return _pcg(apply_a, b, pre, tol=tol, maxiter=maxiter,
                        stag_window=stag_window, comm=comm)
        return _gmres(apply_a, b, pre, m=restart, tol=tol, maxiter=maxiter,
                      comm=comm)

    tcaps = (aux["tin_send"].shape[1], aux["tout_send"].shape[1]) \
        if dshape.p > 1 else (0, 0)
    return {"fn": fn, "apply_a": apply_a, "precond": pre, "fused": fused,
            "hide": hide, "tcaps": tcaps, "dshape": dshape, "mg": mg,
            "args": args, "n": n, "h": h, "mode": mode,
            "schedule": schedule, "backend": backend, "packs": packs}


def make_dist_solve(prob: Dict, comm: Comm, method: str = "pcg",
                    mode: str = "halo-plan", tol: float = 1e-8,
                    maxiter: int = 200, use_precond: bool = True,
                    restart: int = 30, n_cycles: int = 2, nu: int = 3,
                    omega: float = 0.7, schedule: str = "auto",
                    backend: str = "cuda", fused: Optional[bool] = None,
                    stag_window: int = 30, device="cuda") -> Dict:
    """This rank's whole fractional solve over ``comm``: partitions
    ``prob`` for ``comm.p`` ranks on ``device`` (every rank builds the same
    partition and keeps its views) and returns ``make_dist_solve_local``'s
    dict (``args``: the rank's views)."""
    dshape, mg, args = build_dist_problem(prob, comm.p, n_cycles=n_cycles,
                                          nu=nu, omega=omega, device=device)
    args = local_args(dshape, mg, args, comm.rank)
    return make_dist_solve_local(
        dshape, mg, args, comm, prob["n"], prob["h"], method=method,
        mode=mode, tol=tol, maxiter=maxiter, use_precond=use_precond,
        restart=restart, schedule=schedule, backend=backend, fused=fused,
        stag_window=stag_window)


def solve_distributed(n: int, comm: Comm, beta: float = 0.75,
                      tol: float = 1e-8, h2_tol: float = 1e-6,
                      maxiter: int = 200, mode: str = "halo-plan",
                      method: str = "pcg", use_precond: bool = True,
                      construction: str = "cheb", schedule: str = "auto",
                      fused: Optional[bool] = None, device="cuda",
                      backend: str = "cuda", stag_window: int = 30) -> Dict:
    """End-to-end distributed fractional-diffusion solve, run by every
    rank of ``comm``: each builds the problem on ``device`` (the same bits
    on every rank), keeps its shard and solves.

    Returns this rank's strip of the solution ``u`` ([n/p, n], a tensor on
    ``device``) and ``iters``, ``relres``, ``converged``, ``status`` and
    ``history``, equal on every rank; ``prob``, ``parts``
    (``make_dist_solve``), ``recv_bytes`` (received by this rank during
    the solve) and ``solve_s``."""
    dev = torch.device(device)
    prob = FractionalProblem(n, beta=beta, h2_tol=h2_tol,
                             construction=construction, device=device,
                             backend=backend).build()
    parts = make_dist_solve(prob, comm, method=method, mode=mode, tol=tol,
                            maxiter=maxiter, use_precond=use_precond,
                            schedule=schedule, backend=backend, fused=fused,
                            stag_window=stag_window, device=device)
    rows = n // comm.p
    b = torch.ones((rows * n,), dtype=torch.float32, device=dev) * \
        prob["h"] ** 2
    before = comm.recv_bytes
    _sync(dev)
    t0 = time.perf_counter()
    res = parts["fn"](b)
    _sync(dev)
    return {"u": res.x.reshape(rows, n), "iters": int(res.iters),
            "relres": float(res.relres), "converged": bool(res.converged),
            "status": worst_status(res.status), "history": res.res_history,
            "prob": prob, "parts": parts,
            "recv_bytes": comm.recv_bytes - before,
            "solve_s": time.perf_counter() - t0}


# ----------------------------------------------------------------------
# elastic fault-tolerant solve (DESIGN.md §10): segmented PCG with
# checkpointed state, shrink-remesh recovery, and a residual tripwire
# ----------------------------------------------------------------------

def make_dist_solve_segment(prob: Dict, comm: Comm, mode: str = "halo-plan",
                            tol: float = 1e-8, steps: int = 10,
                            maxiter: int = 200, use_precond: bool = True,
                            n_cycles: int = 2, nu: int = 3,
                            omega: float = 0.7, dist_source=None,
                            schedule: str = "auto", backend: str = "cuda",
                            fused: Optional[bool] = None,
                            device="cuda") -> Dict:
    """Segmented (checkpointable) variant of ``make_dist_solve``, run by
    every rank of ``comm``.

    Returns this rank's four callables of the elastic solve --
    ``init(b) -> PCGState``, ``segment(b, state) -> PCGState`` (at most
    ``steps`` iterations, the periodic-exit checkpoint boundary),
    ``residual(b, state) -> (true_relres, rec_relres)`` (the recomputed
    ``||b - A x|| / ||b||`` silent-corruption tripwire, 0-d tensors equal
    on every rank) and ``rebaseline(b, state)`` (a fresh ``r = b - A x``
    from the iterate, keeping ``k``) -- all driving the exact ``pcg``
    recurrence, so total iteration counts match the monolithic solve;
    ``b`` and the state's vectors are the rank's grid-order strips.  Also
    ``dshape``, ``mg``, ``args`` (the rank's views), ``stacked`` (the
    whole stacked partition ``(dshape, ddata)``, the next remesh's
    source), ``fused`` and ``tcaps``.  ``dist_source`` re-shards an
    existing stacked partition (``build_dist_problem``).
    """
    n, h = prob["n"], prob["h"]
    dshape, mg, stacked = build_dist_problem(
        prob, comm.p, n_cycles=n_cycles, nu=nu, omega=omega, device=device,
        dist_source=dist_source)
    args = local_args(dshape, mg, stacked, comm.rank)
    parts = make_dist_solve_local(
        dshape, mg, args, comm, n, h, mode=mode, tol=tol, maxiter=maxiter,
        use_precond=use_precond, schedule=schedule, backend=backend,
        fused=fused)
    apply_a, pre = parts["apply_a"], parts["precond"]

    def init(b: torch.Tensor) -> PCGState:
        return pcg_init(apply_a, b, pre, comm=comm)

    def segment(b: torch.Tensor, state: PCGState) -> PCGState:
        return pcg_segment(apply_a, b, state, pre, tol=tol, steps=steps,
                           maxiter=maxiter, comm=comm)

    def residual(b: torch.Tensor, state: PCGState):
        bn = _norm(b, comm=comm)
        bn_safe = torch.where(bn > 0, bn, 1.0)
        true = _norm(b - apply_a(state.x), comm=comm)
        return true / bn_safe, state.res / bn_safe

    def rebaseline(b: torch.Tensor, state: PCGState) -> PCGState:
        # re-anchor the recurrence on the (possibly rebuilt) operator:
        # fresh r = b - A x from the checkpointed iterate, keeping the
        # iteration count.  Needed after a precision escalation -- the
        # carried r/p/rz of a bf16-payload segment are inconsistent with
        # the fp32 rebuild at the old payload's accuracy level, which
        # would re-fire the corruption tripwire forever.
        st = pcg_init(apply_a, b, pre, x0=state.x, comm=comm)
        return dataclasses.replace(st, k=state.k)

    return {"init": init, "segment": segment, "residual": residual,
            "rebaseline": rebaseline, "dshape": dshape, "mg": mg,
            "args": args, "stacked": (dshape, stacked[0]),
            "fused": parts["fused"], "tcaps": parts["tcaps"]}


def _loss_schedule(plan: ChaosPlan, p: int) -> List[Tuple[int, int]]:
    """The plan's losses in segment order, each shrinking the group to a
    smaller power of two (the port re-shards onto surviving ranks only)."""
    out, cur = [], p
    for seg in sorted(plan.device_loss_at):
        p_new = int(plan.device_loss_at[seg])
        if p_new < 1 or p_new >= cur or p_new & (p_new - 1):
            raise ValueError(f"device loss at segment {seg}: {cur} -> "
                             f"{p_new} ranks is not a shrink to a power "
                             f"of two")
        out.append((seg, p_new))
        cur = p_new
    return out


def solve_elastic_local(prob: Dict, comm: Comm, dist_source,
                        tol: float = 1e-8, maxiter: int = 200,
                        mode: str = "halo-plan", use_precond: bool = True,
                        ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
                        max_restarts: int = 5,
                        chaos: Optional[ChaosPlan] = None,
                        monitor: Optional[StragglerMonitor] = None,
                        ckpt_block: bool = True, schedule: str = "auto",
                        backend: str = "cuda", fused: Optional[bool] = None,
                        device="cuda") -> Dict:
    """One rank's elastic solve (``solve_distributed_elastic``'s body) on
    the stacked partition ``dist_source = (dshape, ddata)`` of the
    operator at ``comm.p`` ranks; ``prob`` needs only the grid arrays
    (``build_dist_problem``).  ``comm`` must span the whole world: a
    device loss builds the survivors' groups with
    ``torch.distributed.new_group``.

    Returns, on a survivor, the reference's dict -- ``u`` (this rank's
    ``[n / p_final, n]`` strip), ``iters``, ``relres``, ``converged``,
    ``status``, ``history`` (the committed segments' recurrence relres),
    ``p_final``, ``comm_final``, ``report`` (``ChaosReport``), ``parts``,
    ``restarts`` -- plus ``true_history`` (the tripwire's recomputed
    relres beside ``history``), ``segments`` (per segment run: its index,
    ``p``, ``k`` after it, wall seconds, bytes this rank received and
    kernel launches during it), ``remesh_s``/``restore_s`` (seconds per
    remesh and per restore) and ``lost_at`` None.  A rank the schedule
    drops returns ``{"lost_at": segment, "p_final": ...}`` after making
    the later losses' group calls.
    """
    import torch.distributed as tdist

    n = prob["n"]
    dev = torch.device(device)
    plan = chaos if chaos is not None else ChaosPlan.empty()
    losses = _loss_schedule(plan, comm.p)
    groups_made = [0]
    report = ChaosReport()
    mon = monitor if monitor is not None else StragglerMonitor()
    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    ctx: Dict = {"mode": mode, "comm": comm}
    extra_log: Dict[str, List] = {"segments": [], "remesh_s": [],
                                  "restore_s": [], "true": []}

    def make_groups(upto: int) -> Optional[object]:
        """Every world rank's ``new_group`` calls of losses
        ``groups_made .. upto - 1``, in schedule order; returns the last."""
        g = None
        for _, p_new in losses[groups_made[0]:upto]:
            g = tdist.new_group(list(range(p_new)))
        groups_made[0] = max(groups_made[0], upto)
        return g

    def build_ctx(source):
        c = ctx["comm"]
        parts = make_dist_solve_segment(
            prob, c, mode=ctx["mode"], tol=tol, steps=ckpt_every,
            maxiter=maxiter, use_precond=use_precond, dist_source=source,
            schedule=schedule, backend=backend, fused=fused, device=device)
        rows = n // c.p
        b = torch.ones((rows * n,), dtype=torch.float32, device=dev) * \
            prob["h"] ** 2
        # the convergence threshold as the segment computes it, on this
        # group (every rank reads the same bits)
        b_norm = _norm(b, comm=c)
        ctx.update(parts=parts, p=c.p, b=b, b_norm=float(b_norm),
                   thr=torch.as_tensor(tol, dtype=b.dtype, device=dev) *
                   b_norm)

    build_ctx(dist_source)
    del dist_source                       # the stacked source lives in ctx
    state = ctx["parts"]["init"](ctx["b"])
    total_segments = -(-int(maxiter) // int(ckpt_every))
    flags = {"converged": False, "lost_at": None}
    pending: Dict = {}
    history: List[float] = []

    def save(seg: int, st: PCGState) -> None:
        """Rank 0 writes one global state: the x, r, p strips gathered
        in rank (= grid row) order, the scalars replicated."""
        c = ctx["comm"]
        g = c.all_gather(torch.stack([st.x, st.r, st.p], dim=1))
        if c.rank == 0:
            glob = PCGState(k=st.k, x=g[:, 0], r=g[:, 1], p=g[:, 2],
                            rz=st.rz, res=st.res, status=st.status)
            mgr.save(seg + 1, glob,
                     extra={"p": ctx["p"], "tol": tol, "comm": ctx["mode"],
                            "n": n, "iters": int(st.k)},
                     block=ckpt_block)

    def step_fn(seg: int) -> None:
        nonlocal state
        if flags["converged"] or flags["lost_at"] is not None:
            return
        p_lost = plan.device_loss(seg)
        if p_lost is not None:
            pending.update(kind="device-loss", segment=seg, p_to=p_lost,
                           k_done=int(state.k), t0=time.perf_counter())
            raise StepFailure(f"device lost at segment {seg} "
                              f"(p {ctx['p']} -> {p_lost})")
        c = ctx["comm"]
        _sync(dev)
        recv0, launches0 = c.recv_bytes, kops.launch_counts()
        t0 = time.perf_counter()
        new_state = ctx["parts"]["segment"](ctx["b"], state)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = {k: v - launches0[k]
                    for k, v in kops.launch_counts().items()}
        extra_log["segments"].append(dict(
            segment=seg, p=ctx["p"], k=int(new_state.k), wall_s=wall,
            recv_bytes=c.recv_bytes - recv0, launches=launches))
        if plan.corrupts(seg):
            # in-flight memory corruption: poison a copy of the fresh
            # iterate AFTER the recurrence computed it -- invisible to the
            # recurrence residual, visible to the recomputed one
            new_state = dataclasses.replace(new_state,
                                            x=new_state.x * float("nan"))
        true_t, rec_t = ctx["parts"]["residual"](ctx["b"], new_state)
        true_rr, rec_rr = float(true_t), float(rec_t)
        wall += plan.straggle(seg)
        report.seg_wall_s.append(wall)
        report.segments_run += 1
        if mon.record(seg, wall):
            report.straggler_flags.append(seg)
            report.events.append(FaultEvent(
                kind="straggler", segment=seg, p_from=ctx["p"],
                p_to=ctx["p"], iters_lost=0, recover_s=0.0))
        st = worst_status(new_state.status)
        if st != 0:
            # the solver's own in-loop breakdown guard (NaN / indefinite
            # carry) -- trips without waiting for the recomputed residual
            pending.update(kind="breakdown", segment=seg, p_to=ctx["p"],
                           k_done=int(new_state.k), t0=time.perf_counter())
            raise StepFailure(
                f"solver guard tripped at segment {seg} (status {st})")
        if not np.isfinite(true_rr) or true_rr > 10.0 * rec_rr + 1e-5:
            pending.update(kind="corruption", segment=seg, p_to=ctx["p"],
                           k_done=int(new_state.k), t0=time.perf_counter())
            raise StepFailure(
                f"residual tripwire at segment {seg}: true relres "
                f"{true_rr:.3e} vs recurrence {rec_rr:.3e}")
        state = new_state
        history.append(rec_rr)
        extra_log["true"].append(true_rr)
        if mgr is not None:
            t0 = time.perf_counter()
            save(seg, state)
            report.ckpt_save_s.append(time.perf_counter() - t0)
        if bool(state.res <= ctx["thr"]):
            flags["converged"] = True

    def restore() -> Tuple[PCGState, int]:
        """Every rank's view of the newest complete checkpoint (rank 0
        finishes its writes first; all meet at a barrier), sliced to this
        rank's strip; the initial state when there is none."""
        c = ctx["comm"]
        if mgr is not None and c.rank == 0:
            mgr.wait()
        c.barrier()
        step = mgr.latest_step() if mgr is not None else None
        if step is None:
            return ctx["parts"]["init"](ctx["b"]), 0
        glob, man = mgr.restore(state, step=step, device=dev)
        rows = glob.x.shape[0] // c.p
        cut = slice(c.rank * rows, (c.rank + 1) * rows)
        return dataclasses.replace(glob, x=glob.x[cut].contiguous(),
                                   r=glob.r[cut].contiguous(),
                                   p=glob.p[cut].contiguous()), \
            int(man["step"])

    def on_restart(at: int) -> int:
        nonlocal state
        kind = pending.get("kind", "unknown")
        p_from = ctx["p"]
        escalated = False
        if kind == "device-loss":
            p_new = pending["p_to"]
            i = [s for s, _ in losses].index(pending["segment"])
            group = make_groups(i + 1)
            me = ctx["comm"].rank
            if me >= p_new:
                # this rank plays a lost device: it takes part in the
                # later losses' group calls and leaves the solve
                make_groups(len(losses))
                flags["lost_at"] = pending["segment"]
                ctx["p"] = p_new
                pending.clear()
                return total_segments
            t0 = time.perf_counter()
            source = ctx["parts"]["stacked"]
            ctx["comm"] = Comm(group)
            ctx.pop("parts")
            build_ctx(source)
            del source
            _sync(dev)
            extra_log["remesh_s"].append(time.perf_counter() - t0)
        elif kind in ("corruption", "breakdown") and \
                ctx["mode"].endswith("-bf16"):
            # precision-escalation rung: a numerically-suspect restart on
            # a bf16-payload exchange drops to full fp32 payloads before
            # resuming from the checkpoint
            ctx["mode"] = ctx["mode"][:-len("-bf16")]
            GUARD_COUNTERS["elastic/fp32-comm"] += 1
            build_ctx(ctx["parts"]["stacked"])
            escalated = True
        t0 = time.perf_counter()
        state, resume = restore()
        if escalated and resume > 0:
            # the checkpointed recurrence was produced by the bf16
            # exchange; re-anchor r/p/rz on the fp32 rebuild so the
            # tripwire compares like against like from here on
            state = ctx["parts"]["rebaseline"](ctx["b"], state)
        _sync(dev)
        extra_log["restore_s"].append(time.perf_counter() - t0)
        k_res = int(state.k)
        report.events.append(FaultEvent(
            kind=kind, segment=pending.get("segment", at), p_from=p_from,
            p_to=ctx["p"], iters_lost=max(0, pending.get("k_done", 0) - k_res),
            recover_s=time.perf_counter() - pending.get("t0",
                                                        time.perf_counter())))
        pending.clear()
        return resume

    _, restarts = run_with_restarts(
        step_fn, start_step=0, total_steps=total_segments,
        max_restarts=max_restarts, on_restart=on_restart)
    if flags["lost_at"] is not None:
        return {"lost_at": flags["lost_at"], "p_final": ctx["p"]}
    make_groups(len(losses))              # the losses that never fired
    if mgr is not None and ctx["comm"].rank == 0:
        mgr.wait()
    report.restarts = restarts
    bn_safe = ctx["b_norm"] if ctx["b_norm"] > 0 else 1.0
    return {"u": state.x.reshape(n // ctx["p"], n), "iters": int(state.k),
            "relres": float(state.res) / bn_safe,
            "converged": bool(state.res <= ctx["thr"]),
            "status": worst_status(state.status), "history": history,
            "true_history": extra_log["true"], "prob": prob,
            "p_final": ctx["p"], "comm_final": ctx["mode"],
            "report": report, "parts": ctx["parts"], "restarts": restarts,
            "segments": extra_log["segments"],
            "remesh_s": extra_log["remesh_s"],
            "restore_s": extra_log["restore_s"], "lost_at": None}


def solve_distributed_elastic(n: int, comm: Comm, beta: float = 0.75,
                              tol: float = 1e-8, h2_tol: float = 1e-6,
                              maxiter: int = 200, mode: str = "halo-plan",
                              use_precond: bool = True,
                              construction: str = "cheb",
                              ckpt_dir: Optional[str] = None,
                              ckpt_every: int = 10, max_restarts: int = 5,
                              chaos: Optional[ChaosPlan] = None,
                              monitor: Optional[StragglerMonitor] = None,
                              ckpt_block: bool = True,
                              schedule: str = "auto",
                              fused: Optional[bool] = None, device="cuda",
                              backend: str = "cuda") -> Dict:
    """Fault-tolerant distributed fractional solve (DESIGN.md §10), run by
    every rank of the world group ``comm``: each builds the problem on
    ``device`` (the same bits on every rank), partitions it for ``comm.p``
    ranks and runs ``solve_elastic_local``.

    The solve runs as segments of ``ckpt_every`` PCG iterations.  After
    each segment rank 0 snapshots the global :class:`PCGState` through
    ``CheckpointManager`` (when ``ckpt_dir`` is given, a directory every
    rank sees) and every rank probes the recomputed true residual against
    the recurrence residual -- a divergence or non-finite value means
    silent state corruption, raised as ``StepFailure`` *without*
    committing the poisoned state.  Recovery is orchestrated by
    ``runtime.fault.run_with_restarts``: on a device loss the operator is
    re-sharded onto the scheduled surviving ranks via ``repartition_h2``,
    the latest *valid* checkpoint is restored and sliced to the new
    strips, and the solve resumes from that segment; corrupted state
    rolls back the same way on the unchanged group.  Stragglers (injected
    via ``chaos`` or real) are flagged by the ``StragglerMonitor`` but
    cost no iterations.  ``mode``, ``schedule``, ``fused`` and
    ``backend`` are ``make_dist_solve``'s.
    """
    prob = FractionalProblem(n, beta=beta, h2_tol=h2_tol,
                             construction=construction, device=device,
                             backend=backend).build()
    source = partition_h2(prob["shape"], prob["data"], comm.p,
                          device=device)
    grid = {k: v for k, v in prob.items() if k not in ("shape", "data")}
    del prob
    return solve_elastic_local(
        grid, comm, source, tol=tol, maxiter=maxiter, mode=mode,
        use_precond=use_precond, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
        max_restarts=max_restarts, chaos=chaos, monitor=monitor,
        ckpt_block=ckpt_block, schedule=schedule, backend=backend,
        fused=fused, device=device)


def dist_solve_comm_bytes(dshape: DistH2Shape, mg, mode: str = "halo-plan",
                          bytes_per_el: int = 4,
                          tcaps: Optional[Tuple[int, int]] = None,
                          fused: Optional[bool] = None) -> int:
    """Modeled per-rank bytes received by ONE distributed PCG iteration on
    the fractional operator.

    Two-step (``fused=False``): H^2 matvec exchange + the two grid<->tree
    transposition all_gathers + the C-stencil row halo + the V-cycle
    halos (``mg_halo_bytes``) + the three psum'd CG scalars.  Fused
    (DESIGN.md §12): the branch-root gather + ONE merged H^2 all_to_all
    (``merged_exchange_bytes``), the two plan-compressed transposition
    all_to_alls (``tcaps`` = their per-peer row caps, from
    ``make_dist_solve(...)["tcaps"]``; the inbound one carries the
    stencil halo lanes), the fused V-cycle halos, and the psums."""
    p = dshape.p
    if p <= 1:
        return 0
    fused = _fused_default(fused, mode)
    psums = 3 * (p - 1) * bytes_per_el
    if fused and tcaps is not None:
        if mode.startswith("halo-plan"):
            # merged single-round H^2 exchange
            k_lc = dshape.ranks[dshape.lc]
            mv = (p - 1) * k_lc * bytes_per_el \
                + merged_exchange_bytes(dshape, 1, mode, bytes_per_el)
        else:
            # allgather/ppermute keep their per-level exchange even when
            # the transpositions and V-cycle are fused
            mv = matvec_comm_bytes(dshape, 1, mode, bytes_per_el)
        cap_in, cap_out = tcaps
        # inbound lanes + the [p, n]-wide stencil-halo extra lanes
        transpose = (p - 1) * (cap_in + mg.levels[0] + cap_out) \
            * bytes_per_el
        return mv + transpose + psums + mg_halo_bytes(
            mg, bytes_per_el, fused=True, bf16=mode.endswith("-bf16"))
    mv = matvec_comm_bytes(dshape, 1, mode, bytes_per_el)
    transpose = 2 * (p - 1) * (dshape.n // p) * bytes_per_el
    stencil = 2 * mg.levels[0] * bytes_per_el
    return mv + transpose + stencil + mg_halo_bytes(mg, bytes_per_el) \
        + psums


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
