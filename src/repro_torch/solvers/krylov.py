"""Krylov solvers (the reference's ``repro/solvers/krylov.py``), on one
device or over the ranks of a ``Comm``.

The reference runs each solver as one ``lax.while_loop`` program.  Torch
has no device-side loop, so here each solver is a host loop over
fixed-length *segments* (``solvers/graphs.py``): a segment runs
``SEGMENT_STEPS`` iterations (``steps`` for ``pcg_segment``, one restart of
``m`` Arnoldi steps for GMRES), each computing
the reference's loop body and keeping its result only where the
reference's loop condition held (``torch.where`` on a device-side flag).
Once the condition fails the carry is frozen exactly as the
``while_loop`` would have left it, so iteration counts and iterates follow
the reference's recurrence.  The host reads one flag per segment and no
other value; the residual history is written through device indices.  On
CUDA tensors a segment is captured once into a CUDA graph and replayed.

Distributed (the reference's ``axis=``): every solver takes ``comm`` (a
``core.comm.Comm``); ``b``, the iterates and ``apply_a``/``precond`` are
then the rank's shard, and every dot product is summed over the ranks by
``Comm.psum``, whose rank-order sum gives every rank the same bits, so all
ranks read the same flag and leave the loop at the same segment.  A
segment with collectives runs eagerly: gloo stages every payload through
the host, which a CUDA graph cannot capture (``graph=True`` raises).

Tolerance semantics (as the reference): ``tol`` is always **relative to
||b||** -- convergence is ``||r|| <= tol * ||b||``, ``relres`` and every
entry of ``res_history`` are ``||r|| / ||b||``.  For ``b = 0`` the exact
solution ``x = 0`` is returned with ``iters = 0``, ``relres = 0`` and
``converged = True``.

``res_history`` is a fixed-length ``[maxiter + 1]`` tensor: entry ``i`` is
the relative residual after ``i`` iterations; entries past the solve's end
are NaN.  For ``block_cg`` the history is ``[maxiter + 1, nv]`` and a
column converged at iteration ``k`` carries its final value forward while
other columns still run (rows past the LAST column's finish are NaN;
per-column counts live in ``iters``).  For GMRES the history is per
*restart* (entry ``i`` = relative true residual after ``i`` restart
cycles).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import torch

from repro_torch.obs.trace import phase

from .graphs import SegmentRunner

# captures of each solver's segment program (test hook; the reference's
# retrace counters)
TRACE_COUNTS = {"pcg": 0, "block_cg": 0, "gmres": 0, "pcg_segment": 0}
# iterations per segment of pcg and block_cg: the host reads one flag per
# segment, and a solve runs at most SEGMENT_STEPS - 1 masked iterations
# past its end
SEGMENT_STEPS = 10

# ----------------------------------------------------------------------
# breakdown-guard status codes.  The codes ride the segment carry as one
# int32 tensor (per-column [nv] for block_cg) -- device-side ops, no extra
# host syncs -- and surface in ``SolveResult.status``.
# ``repro_torch.guard.status`` re-exports them with names.
# ----------------------------------------------------------------------
STATUS_OK = 0            # clean (possibly unconverged-at-maxiter) solve
STATUS_NAN = 1           # non-finite residual / <r,z> in the carry
STATUS_INDEFINITE = 2    # p^T A p <= 0: operator not SPD on this Krylov space
STATUS_STAGNATION = 3    # no residual progress over the stagnation window
STATUS_BREAKDOWN = 4     # GMRES least-squares breakdown (non-finite update)

_GUARD_ENABLED = os.environ.get("REPRO_GUARD_DISABLE", "0") != "1"


def guards_enabled() -> bool:
    return _GUARD_ENABLED


def set_guards_enabled(flag: bool) -> None:
    """Global kill-switch for the breakdown guards: with guards disabled,
    solvers called afterwards carry no status machinery (the same as a
    per-call ``guard=False``)."""
    global _GUARD_ENABLED
    _GUARD_ENABLED = bool(flag)


@dataclasses.dataclass
class SolveResult:
    """Solution + convergence record of one Krylov solve.

    ``x``: the solution (same shape as ``b``); ``iters``: iterations taken
    (int32 scalar; for ``block_cg`` an ``[nv]`` vector, for ``gmres`` the
    number of restart cycles x m); ``relres``: final ``||r|| / ||b||``;
    ``converged``: ``||r|| <= tol * ||b||``; ``res_history``: see module
    docstring; ``status``: breakdown-guard code (int32 scalar, per-column
    ``[nv]`` for ``block_cg``; ``STATUS_OK`` when guards are off).
    """
    x: torch.Tensor
    iters: torch.Tensor
    relres: torch.Tensor
    converged: torch.Tensor
    res_history: torch.Tensor
    status: Optional[torch.Tensor] = None


@dataclasses.dataclass
class PCGState:
    """Resumable PCG carry at an iteration boundary: ``k`` iterations
    completed (int32), the iterate ``x``, residual ``r``, search direction
    ``p``, the ``<r, z>`` scalar ``rz``, the absolute residual norm
    ``res`` and the status code.  ``pcg_init`` + repeated ``pcg_segment``
    calls reproduce ``pcg``'s iterates bit for bit."""
    k: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    res: torch.Tensor
    status: Optional[torch.Tensor] = None


def _psum(v: torch.Tensor, comm=None) -> torch.Tensor:
    """``v`` summed over the ranks of ``comm`` (unchanged without one)."""
    if comm is None or comm.p == 1:
        return v
    with phase("krylov/psum"):
        return comm.psum(v)


def _dot(u: torch.Tensor, v: torch.Tensor, dt=None, comm=None
         ) -> torch.Tensor:
    """Global <u, v> over all elements, summed over the ranks of ``comm``
    when sharded.  ``dt`` (the fp64 escalation hook): accumulate the
    products in that dtype."""
    if dt is not None:
        u = u.to(dt)
        v = v.to(dt)
    return _psum(torch.sum(u * v), comm)


def _norm(u: torch.Tensor, dt=None, comm=None) -> torch.Tensor:
    return torch.sqrt(_dot(u, u, dt, comm))


def _cdot(u: torch.Tensor, v: torch.Tensor, dt=None, comm=None
          ) -> torch.Tensor:
    """Per-column <u_j, v_j> for [n, nv] blocks -> [nv]."""
    if dt is not None:
        u = u.to(dt)
        v = v.to(dt)
    return _psum(torch.sum(u * v, dim=0), comm)


def _identity(r):
    return r


def _code(cond: torch.Tensor, yes: int, no) -> torch.Tensor:
    """int32 ``where(cond, yes, no)`` (``no`` an int or an int32 tensor)."""
    return torch.where(cond, yes, no).to(torch.int32)


def _keep(active: torch.Tensor, new, old):
    """The carry after one masked iteration: ``new`` where the loop
    condition held, else ``old`` unchanged."""
    return tuple(torch.where(active, a, b) for a, b in zip(new, old))


def _at(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``v[i]`` for a device index ``i`` (int32 scalar), no host read."""
    return v.index_select(0, i.long().reshape(1))[0]


def _pcg_step(apply_a, m, x, r, p, rz, sdt=None, comm=None):
    """One PCG iteration -- the shared body of ``pcg`` and ``pcg_segment``
    (identical op order keeps the two bitwise-equal).  Also returns
    ``pap`` for the indefiniteness guard.  ``sdt``: scalar-accumulation
    dtype (fp64 escalation); scalars are cast back to the vector dtype
    before touching the iterates.  ``comm``: the three dot products are
    summed over its ranks."""
    with phase("krylov/apply-A"):
        ap = apply_a(p)
    with phase("krylov/scalars"):
        pap = _dot(p, ap, sdt, comm)
        alpha = rz / torch.where(pap != 0, pap, 1.0)
        if sdt is not None:
            alpha = alpha.to(x.dtype)
        x = x + alpha * p
        r = r - alpha * ap
        res = _norm(r, sdt, comm)
    with phase("krylov/precond"):
        z = m(r)
    with phase("krylov/scalars"):
        rz_new = _dot(r, z, sdt, comm)
        beta = rz_new / torch.where(rz != 0, rz, 1.0)
        if sdt is not None:
            beta = beta.to(x.dtype)
        p = z + beta * p
    return x, r, p, rz_new, res, pap


def _new_status(finite, pap, stalled=None) -> torch.Tensor:
    inner = STATUS_OK if stalled is None else \
        _code(stalled, STATUS_STAGNATION, STATUS_OK)
    return _code(~finite, STATUS_NAN,
                 _code(pap <= 0, STATUS_INDEFINITE, inner))


def _segments(maxiter: int, steps: int) -> int:
    return max(0, -(-int(maxiter) // int(steps)))


def pcg_init(apply_a: Callable, b: torch.Tensor,
             precond: Optional[Callable] = None,
             x0: Optional[torch.Tensor] = None,
             guard: bool = True, comm=None) -> PCGState:
    """Initial :class:`PCGState` for a segmented solve -- the same prologue
    as :func:`pcg` (``x0=None`` starts from ``r = b`` without an operator
    application).  ``comm``: see the module docstring."""
    g = bool(guard) and _GUARD_ENABLED
    m = precond if precond is not None else _identity
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - apply_a(x) if x0 is not None else b
    z = m(r)
    rz = _dot(r, z, comm=comm)
    res = _norm(r, comm=comm)
    if g:
        status = _code(torch.isfinite(res) & torch.isfinite(rz), STATUS_OK,
                       STATUS_NAN)
    else:
        status = torch.zeros((), dtype=torch.int32, device=b.device)
    return PCGState(k=torch.zeros((), dtype=torch.int32, device=b.device),
                    x=x, r=r, p=z, rz=rz, res=res, status=status)


def pcg_segment(apply_a: Callable, b: torch.Tensor, state: PCGState,
                precond: Optional[Callable] = None, tol: float = 1e-8,
                steps: int = 10, maxiter: int = 200, guard: bool = True,
                graph: Optional[bool] = None, comm=None) -> PCGState:
    """Advance a PCG solve by at most ``steps`` iterations.

    The exact :func:`pcg` recurrence, which additionally stops after
    ``steps`` iterations and hands the carry back to the host.  The
    convergence test is unchanged (``res <= tol * ||b||`` ends the solve
    regardless of segment position), so total iteration counts match the
    monolithic ``pcg`` exactly.  ``guard``: carry the breakdown status
    (NaN/Inf, indefiniteness -- no stagnation window: the segment carries
    no residual history).  ``graph``: see ``solvers/graphs.py`` (default:
    captured on CUDA tensors).  ``comm``: see the module docstring.  No
    host sync.
    """
    g = bool(guard) and _GUARD_ENABLED
    m = precond if precond is not None else _identity
    steps, maxiter = int(steps), int(maxiter)
    thr = torch.as_tensor(tol, dtype=b.dtype, device=b.device) * \
        _norm(b, comm=comm)
    status = state.status if state.status is not None else \
        torch.zeros((), dtype=torch.int32, device=b.device)

    def seg(k, x, r, p, rz, res, status, thr):
        k_stop = torch.clamp(k + steps, max=maxiter)
        for _ in range(steps):
            active = (k < k_stop) & (res > thr)
            if g:
                active = active & (status == STATUS_OK)
            x2, r2, p2, rz2, res2, pap = _pcg_step(apply_a, m, x, r, p, rz,
                                                   comm=comm)
            status2 = status
            if g:
                with phase("krylov/guard"):
                    finite = torch.isfinite(res2) & torch.isfinite(rz2)
                    status2 = _code(status == STATUS_OK,
                                    _new_status(finite, pap), status)
            k, x, r, p, rz, res, status = _keep(
                active, (k + 1, x2, r2, p2, rz2, res2, status2),
                (k, x, r, p, rz, res, status))
        return (k, x, r, p, rz, res, status, thr), res > thr

    runner = SegmentRunner(("pcg_segment", (apply_a, precond),
                            (steps, maxiter, g)), seg,
                           (state.k, state.x, state.r, state.p, state.rz,
                            state.res, status, thr), graph, TRACE_COUNTS,
                           collectives=comm is not None)
    runner.run()
    k, x, r, p, rz, res, status, _ = runner.result()
    return PCGState(k=k, x=x, r=r, p=p, rz=rz, res=res, status=status)


def pcg(apply_a: Callable, b: torch.Tensor,
        precond: Optional[Callable] = None, tol: float = 1e-8,
        maxiter: int = 200, x0: Optional[torch.Tensor] = None,
        guard: bool = True, stag_window: int = 30, scalar_dtype=None,
        graph: Optional[bool] = None, comm=None) -> SolveResult:
    """Preconditioned conjugate gradients in segments of
    ``SEGMENT_STEPS`` iterations.

    ``apply_a``/``precond`` map tensors of ``b``'s shape to the same shape;
    ``precond`` must apply a fixed SPD ``M^{-1}``.

    ``guard``: carry a breakdown-status int32 and end the loop on NaN/Inf
    in the carry, ``p^T A p <= 0`` (indefiniteness) or no residual
    progress over ``stag_window`` iterations -- device-side ops, no extra
    host syncs.  ``guard=False`` (or ``set_guards_enabled(False)``) leaves
    every guard op out.  ``scalar_dtype``: accumulate the dot-product
    scalars in this dtype (the fp64 escalation rung; vector iterates keep
    ``b``'s dtype).  ``graph``: see ``solvers/graphs.py`` (default:
    captured on CUDA tensors).  ``comm``: see the module docstring.  One
    host sync per segment.
    """
    g = bool(guard) and _GUARD_ENABLED
    sdt = scalar_dtype
    cast = (lambda v: v.to(b.dtype)) if sdt is not None else (lambda v: v)
    m = precond if precond is not None else _identity
    steps, maxiter = SEGMENT_STEPS, int(maxiter)
    dev = b.device
    b_norm = _norm(b, sdt, comm)
    bn_safe = torch.where(b_norm > 0, b_norm, 1.0)
    thr = torch.as_tensor(tol, dtype=b_norm.dtype, device=dev) * b_norm
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - apply_a(x) if x0 is not None else b
    z = m(r)
    rz = _dot(r, z, sdt, comm)
    res = _norm(r, sdt, comm)
    hist = torch.full((maxiter + 1,), float("nan"), dtype=b.dtype,
                      device=dev)
    hist[0] = cast(res / bn_safe)
    W = max(1, min(int(stag_window), maxiter))
    if g:
        status = _code(torch.isfinite(res) & torch.isfinite(rz), STATUS_OK,
                       STATUS_NAN)
    else:
        status = torch.zeros((), dtype=torch.int32, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)

    def cond(k, res, status, thr):
        keep = (k < maxiter) & (res > thr)
        return keep & (status == STATUS_OK) if g else keep

    def seg(k, x, r, p, rz, res, hist, status, bn_safe, thr):
        for _ in range(steps):
            active = cond(k, res, status, thr)
            x2, r2, p2, rz2, res2, pap = _pcg_step(apply_a, m, x, r, p, rz,
                                                   sdt, comm)
            with phase("krylov/scalars"):
                k1 = k + 1
                kc = torch.clamp(k1, max=maxiter)    # in range when frozen
                hist2 = hist.index_copy(0, kc.long().reshape(1),
                                        cast(res2 / bn_safe).reshape(1))
            status2 = status
            if g:
                with phase("krylov/guard"):
                    finite = torch.isfinite(res2) & torch.isfinite(rz2)
                    stalled = (k1 >= W) & (
                        _at(hist2, kc) >= _at(hist2, torch.clamp(k1 - W,
                                                                 min=0)))
                    status2 = _code(status == STATUS_OK,
                                    _new_status(finite, pap, stalled),
                                    status)
            k, x, r, p, rz, res, hist, status = _keep(
                active, (k1, x2, r2, p2, rz2, res2, hist2, status2),
                (k, x, r, p, rz, res, hist, status))
        return ((k, x, r, p, rz, res, hist, status, bn_safe, thr),
                cond(k, res, status, thr))

    runner = SegmentRunner(("pcg", (apply_a, precond),
                            (maxiter, steps, g, sdt, W)), seg,
                           (k, x, r, z, rz, res, hist, status, bn_safe, thr),
                           graph, TRACE_COUNTS, collectives=comm is not None)
    for _ in range(_segments(maxiter, steps)):
        if not runner.step():
            break
    k, x, r, _, _, res, hist, status, _, _ = runner.result()
    conv = res <= thr
    if g:
        # a solve that stalls exactly on the tolerance boundary converged;
        # don't report the final-iteration stagnation flag
        status = _code((status == STATUS_STAGNATION) & conv, STATUS_OK,
                       status)
    return SolveResult(x=x, iters=k, relres=cast(res / bn_safe),
                       converged=conv, res_history=hist, status=status)


def block_cg(apply_a: Callable, b: torch.Tensor,
             precond: Optional[Callable] = None, tol: float = 1e-8,
             maxiter: int = 200, x0: Optional[torch.Tensor] = None,
             guard: bool = True, stag_window: int = 30, scalar_dtype=None,
             graph: Optional[bool] = None, comm=None) -> SolveResult:
    """Batched multi-RHS CG: ``b`` is ``[n, nv]``, ``apply_a`` maps
    ``[n, nv] -> [n, nv]`` (the H^2 matvec's native multi-vector form).

    Each column runs an independent CG recurrence (per-column alpha/beta),
    all in one segment program so the nv matvecs share every launch.
    Converged columns are frozen via masking; ``iters`` is per-column.
    ``x0`` warm-starts every column; already-converged columns take zero
    iterations.  ``tol`` may be a scalar tensor: the tolerance rides the
    segment's state, so one captured program serves any tolerance.

    ``guard``: per-column breakdown status (``SolveResult.status`` is
    ``[nv]``); a broken column freezes while healthy columns keep running.
    ``scalar_dtype``, ``graph``, ``comm``: see :func:`pcg`.
    """
    g = bool(guard) and _GUARD_ENABLED
    sdt = scalar_dtype
    cast = (lambda v: v.to(b.dtype)) if sdt is not None else (lambda v: v)
    m = precond if precond is not None else _identity
    steps, maxit = SEGMENT_STEPS, int(maxiter)
    dev = b.device
    b_norm = torch.sqrt(_cdot(b, b, sdt, comm))           # [nv]
    bn_safe = torch.where(b_norm > 0, b_norm, 1.0)
    thr = torch.as_tensor(tol, dtype=b_norm.dtype, device=dev) * b_norm
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - apply_a(x) if x0 is not None else b
    z = m(r)
    rz = _cdot(r, z, sdt, comm)
    res = torch.sqrt(_cdot(r, r, sdt, comm))
    nv = b.shape[1]
    hist = torch.full((maxit + 1, nv), float("nan"), dtype=b.dtype,
                      device=dev)
    hist[0] = cast(res / bn_safe)
    iters = torch.zeros((nv,), dtype=torch.int32, device=dev)
    W = max(1, min(int(stag_window), maxit))
    if g:
        status = _code(torch.isfinite(res) & torch.isfinite(rz), STATUS_OK,
                       STATUS_NAN).expand(nv).contiguous()
    else:
        status = torch.zeros((nv,), dtype=torch.int32, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)

    def columns(res, status, thr):
        act = res > thr
        return act & (status == STATUS_OK) if g else act

    def seg(k, x, r, p, rz, res, hist, iters, status, bn_safe, thr):
        for _ in range(steps):
            active = columns(res, status, thr)                # [nv]
            go = (k < maxit) & active.any()
            with phase("krylov/apply-A"):
                ap = apply_a(p)
            pap = _cdot(p, ap, sdt, comm)
            alpha = torch.where(
                active, cast(rz / torch.where(pap != 0, pap, 1.0)), 0.0)
            x2 = x + alpha[None, :] * p
            r2 = torch.where(active[None, :], r - alpha[None, :] * ap, r)
            res2 = torch.sqrt(_cdot(r2, r2, sdt, comm))
            with phase("krylov/precond"):
                z = m(r2)
            rz2 = torch.where(active, _cdot(r2, z, sdt, comm), rz)
            beta = torch.where(
                active, cast(rz2 / torch.where(rz != 0, rz, 1.0)), 0.0)
            p2 = torch.where(active[None, :], z + beta[None, :] * p, p)
            k1 = k + 1
            kc = torch.clamp(k1, max=maxit)          # in range when frozen
            row = torch.where(active, cast(res2 / bn_safe),
                              _at(hist, torch.clamp(k, max=maxit)))
            hist2 = hist.index_copy(0, kc.long().reshape(1), row[None])
            iters2 = iters + active.to(torch.int32)
            status2 = status
            if g:
                with phase("krylov/guard"):
                    finite = torch.isfinite(res2) & torch.isfinite(rz2)
                    stalled = (k1 >= W) & (
                        _at(hist2, kc) >= _at(hist2, torch.clamp(k1 - W,
                                                                 min=0)))
                    status2 = _code(active & (status == STATUS_OK),
                                    _new_status(finite, pap, stalled),
                                    status)
            k, x, r, p, rz, res, hist, iters, status = _keep(
                go, (k1, x2, r2, p2, rz2, res2, hist2, iters2, status2),
                (k, x, r, p, rz, res, hist, iters, status))
        flag = (k < maxit) & columns(res, status, thr).any()
        return (k, x, r, p, rz, res, hist, iters, status, bn_safe, thr), flag

    runner = SegmentRunner(("block_cg", (apply_a, precond),
                            (maxit, steps, g, sdt, W)), seg,
                           (k, x, r, z, rz, res, hist, iters, status,
                            bn_safe, thr), graph, TRACE_COUNTS,
                           collectives=comm is not None)
    for _ in range(_segments(maxit, steps)):
        if not runner.step():
            break
    _, x, r, _, _, res, hist, iters, status, _, _ = runner.result()
    if g:
        status = _code((status == STATUS_STAGNATION) & (res <= thr),
                       STATUS_OK, status)
    return SolveResult(x=x, iters=iters, relres=cast(res / bn_safe),
                       converged=torch.all(res <= thr), res_history=hist,
                       status=status)


def _arnoldi(op: Callable, v0: torch.Tensor, m: int, comm=None):
    """m steps of Arnoldi with two-pass classical Gram-Schmidt.

    Returns (V [m+1, n...], H [m+1, m]).  The CGS projections are
    vectorized over the whole basis with an ``i <= j`` mask, so every step
    has the same shapes; the second pass restores the orthogonality
    one-pass CGS loses in f32.  ``comm``: the projections and norms are
    summed over its ranks.  Happy breakdown (``h_{j+1,j} ~ 0``) zeroes
    the next basis vector, which leaves the least-squares solve well-posed.
    """
    dims = tuple(range(1, v0.dim() + 1))
    V = torch.cat([v0[None], v0.new_zeros((m,) + tuple(v0.shape))])
    H = v0.new_zeros((m + 1, m))
    ar = torch.arange(m + 1, device=v0.device)

    def vdot_all(V, w):
        return _psum(torch.sum(V * w[None], dim=dims), comm)   # [m+1]

    for j in range(m):
        with phase("krylov/apply-A"):
            w = op(V[j])
        mask = (ar <= j).to(w.dtype)
        h1 = vdot_all(V, w) * mask
        w = w - torch.tensordot(h1, V, dims=1)
        h2 = vdot_all(V, w) * mask                       # CGS second pass
        w = w - torch.tensordot(h2, V, dims=1)
        h = h1 + h2
        hn = _norm(w, comm=comm)
        v_next = torch.where(hn > 0, w / torch.where(hn > 0, hn, 1.0), 0.0)
        V[j + 1] = v_next
        H[:, j] = torch.where(ar == j + 1, hn, h)
    return V, H


def _solve_spd(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``a^{-1} rhs`` for a small SPD ``a`` by Gauss-Jordan elimination
    without pivoting, in device-side tensor ops only (no host sync, so it
    can be captured; the reference calls ``jnp.linalg.solve``).  A zero
    pivot gives a non-finite result, which GMRES reports as breakdown."""
    n = a.shape[0]
    aug = torch.cat([a, rhs[:, None]], dim=1)
    rows = torch.arange(n, device=a.device)[:, None]
    for j in range(n):
        row = aug[j] / aug[j, j]
        aug = torch.where(rows == j, row[None, :],
                          aug - aug[:, j:j + 1] * row[None, :])
    return aug[:, n]


def gmres(apply_a: Callable, b: torch.Tensor,
          precond: Optional[Callable] = None, m: int = 30,
          tol: float = 1e-8, maxiter: int = 200,
          x0: Optional[torch.Tensor] = None, guard: bool = True,
          graph: Optional[bool] = None, comm=None) -> SolveResult:
    """Restarted GMRES(m), left-preconditioned; one restart per segment.

    Each restart runs exactly ``m`` Arnoldi steps on ``M^{-1} A``, solves
    the ``(m+1) x m`` least-squares problem by ridge-regularized normal
    equations (breakdown-safe), and updates ``x``.  Restarts continue until
    the TRUE residual ``||b - A x||`` meets ``tol * ||b||`` or
    ``ceil(maxiter / m)`` cycles have run.  ``res_history`` is per restart;
    ``iters = cycles * m``.

    ``guard``: surface breakdown as ``SolveResult.status`` --
    ``STATUS_BREAKDOWN`` when a restart's least-squares update turned
    non-finite, ``STATUS_NAN`` for a non-finite initial residual, and
    ``STATUS_STAGNATION`` when the accept-only-improving restart logic
    ended the solve without convergence.  ``graph``, ``comm``: see
    :func:`pcg`.
    """
    g_on = bool(guard) and _GUARD_ENABLED
    mp = precond if precond is not None else _identity
    m = int(m)
    n_restarts = max(1, -(-int(maxiter) // m))
    dev = b.device
    b_norm = _norm(b, comm=comm)
    bn_safe = torch.where(b_norm > 0, b_norm, 1.0)
    thr = torch.as_tensor(tol, dtype=b.dtype, device=dev) * b_norm
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - apply_a(x) if x0 is not None else b
    res = _norm(r, comm=comm)
    hist = torch.full((n_restarts + 1,), float("nan"), dtype=b.dtype,
                      device=dev)
    hist[0] = res / bn_safe
    if g_on:
        status = _code(torch.isfinite(res), STATUS_OK, STATUS_NAN)
    else:
        status = torch.zeros((), dtype=torch.int32, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    progress = torch.ones((), dtype=torch.bool, device=dev)

    def op(v):
        return mp(apply_a(v))

    def cond(k, res, progress, thr):
        # a rejected restart leaves the state bitwise unchanged -- further
        # cycles would deterministically recompute the same rejected
        # correction, so stagnation ends the solve
        return (k < n_restarts) & (res > thr) & progress

    def seg(k, x, r, res_old, hist, progress, status, b, bn_safe, thr):
        active = cond(k, res_old, progress, thr)
        with phase("krylov/precond"):
            z = mp(r)
        beta = _norm(z, comm=comm)
        beta_safe = torch.where(beta > 0, beta, 1.0)
        with phase("krylov/arnoldi"):
            V, H = _arnoldi(op, z / beta_safe, m, comm)
        # min_y ||beta e1 - H y||: ridge-regularized normal equations keep
        # the solve well-posed through happy breakdown (zero H columns)
        e1 = torch.cat([beta.reshape(1).to(b.dtype), b.new_zeros(m)])
        gram = H.T @ H
        ridge = 1e-7 * (torch.trace(gram) / m + 1e-30)
        y = _solve_spd(gram + ridge * torch.eye(m, dtype=b.dtype,
                                                device=b.device), H.T @ e1)
        x_new = x + torch.tensordot(y, V[:m], dims=1)
        r_new = b - apply_a(x_new)
        res_new = _norm(r_new, comm=comm)
        # accept only improving restarts: at the dtype's stagnation floor
        # the correction is pure rounding noise and must not grow ||r||
        better = res_new < res_old
        x2 = torch.where(better, x_new, x)
        r2 = torch.where(better, r_new, r)
        res2 = torch.where(better, res_new, res_old)
        k1 = k + 1
        hist2 = hist.index_copy(
            0, torch.clamp(k1, max=n_restarts).long().reshape(1),
            (res2 / bn_safe).reshape(1))
        status2 = status
        if g_on:
            with phase("krylov/guard"):
                # a non-finite LS update is a breakdown, not mere
                # stagnation (the rejected carry hides it from the record)
                brk = ~torch.isfinite(res_new)
                status2 = _code((status == STATUS_OK) & brk,
                                STATUS_BREAKDOWN, status)
        k, x, r, res, hist, progress, status = _keep(
            active, (k1, x2, r2, res2, hist2, better, status2),
            (k, x, r, res_old, hist, progress, status))
        return ((k, x, r, res, hist, progress, status, b, bn_safe, thr),
                cond(k, res, progress, thr))

    runner = SegmentRunner(("gmres", (apply_a, precond), (m, n_restarts,
                                                          g_on)), seg,
                           (k, x, r, res, hist, progress, status, b,
                            bn_safe, thr), graph, TRACE_COUNTS,
                           collectives=comm is not None)
    for _ in range(n_restarts):
        if not runner.step():
            break
    k, x, _, res, hist, progress, status, _, _, _ = runner.result()
    conv = res <= thr
    if g_on:
        status = _code(~conv & ~progress & (status == STATUS_OK),
                       STATUS_STAGNATION, status)
        status = _code(conv, STATUS_OK, status)
    return SolveResult(x=x, iters=k * m, relres=res / bn_safe,
                       converged=conv, res_history=hist, status=status)
