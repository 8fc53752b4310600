"""Distributed Krylov solvers over the block-row H^2 stack (the reference's
``repro/solvers/distributed.py``).

The builders here wrap the solvers of ``solvers.krylov`` around
``core.dist.dist_h2_matvec_local``: every rank runs the whole iteration on
its shard -- matvec (compressed-halo exchange, ``mode="halo-plan"`` by
default), dot products (``Comm.psum``), convergence test -- and all ranks
read the same flag once a segment.  They return per-rank callables over a
``Comm``, as ``dist.make_dist_matvec`` does: ``d`` is the rank's shard
(``dist.local_shard``) and ``b`` its rows.  The segments run eagerly (a
segment with collectives is not captured into a CUDA graph).

``make_dist_krylov`` solves ``(shift*I + A) x = b`` for the plain H^2
operator ``A`` (``shift > 0`` gives the SPD covariance-solve form
``I + A``).  The fractional-diffusion solve, whose operator composes the
H^2 kernel with a sharded stencil and grid<->tree transpositions, lives in
``apps.fractional`` and reuses the same solvers.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.core.comm import Comm
from repro_torch.core.dist import (COMMS, DistH2Data, DistH2Shape,
                                   dist_h2_matvec_local, matvec_comm_bytes)

from .krylov import (PCGState, SolveResult, _norm, block_cg, gmres, pcg,
                     pcg_init, pcg_segment)

METHODS = ("pcg", "gmres", "block_cg")


def _operator(dshape: DistH2Shape, comm: Comm, mode: str, shift: float,
              schedule: str, backend: str, hide_flops: int
              ) -> Callable[[DistH2Data], Callable]:
    """``d -> apply_a``: ``x -> shift*x + A x`` on the rank's rows, for a
    vector ``[n_local]`` or a block ``[n_local, nv]``."""
    if mode not in COMMS:
        raise ValueError(f"unknown comm mode {mode!r}; expected {COMMS}")
    tables: dict = {}             # the halo-plan exchange's pack tables

    def bind(d: DistH2Data) -> Callable:
        def apply_a(x: torch.Tensor) -> torch.Tensor:
            xm = x if x.dim() == 2 else x[:, None]
            y = dist_h2_matvec_local(dshape, d, xm, comm, mode, backend,
                                     schedule, hide_flops, tables)
            y = y if x.dim() == 2 else y[:, 0]
            return shift * x + y if shift else y
        return apply_a
    return bind


def make_dist_krylov_segment(dshape: DistH2Shape, comm: Comm,
                             mode: str = "halo-plan", shift: float = 0.0,
                             tol: float = 1e-8, steps: int = 10,
                             maxiter: int = 200, schedule: str = "auto",
                             backend: str = "cuda", hide_flops: int = 0
                             ) -> Dict[str, Callable]:
    """Segmented distributed PCG on ``(shift*I + A)``: three per-rank
    callables of the elastic solve (DESIGN.md §10).

      - ``init(d, b) -> PCGState``
      - ``segment(d, b, state) -> PCGState`` -- at most ``steps``
        iterations, exiting early on convergence; the exact ``pcg``
        recurrence, so iteration counts match the monolithic solve
      - ``residual(d, b, state) -> (true_relres, rec_relres)`` -- the
        recomputed ``||b - (shift*I + A) x|| / ||b||`` next to the
        recurrence residual, the silent-corruption tripwire
    """
    bind = _operator(dshape, comm, mode, shift, schedule, backend,
                     hide_flops)

    def init(d: DistH2Data, b: torch.Tensor) -> PCGState:
        return pcg_init(bind(d), b, comm=comm)

    def segment(d: DistH2Data, b: torch.Tensor, state: PCGState
                ) -> PCGState:
        return pcg_segment(bind(d), b, state, tol=tol, steps=steps,
                           maxiter=maxiter, comm=comm)

    def residual(d: DistH2Data, b: torch.Tensor, state: PCGState):
        bn = _norm(b, comm=comm)
        bn_safe = torch.where(bn > 0, bn, 1.0)
        true = _norm(b - bind(d)(state.x), comm=comm)
        return true / bn_safe, state.res / bn_safe

    return {"init": init, "segment": segment, "residual": residual}


def make_dist_krylov(dshape: DistH2Shape, comm: Comm, method: str = "pcg",
                     mode: str = "halo-plan", shift: float = 0.0,
                     tol: float = 1e-8, maxiter: int = 200,
                     restart: int = 30, schedule: str = "auto",
                     backend: str = "cuda", hide_flops: int = 0
                     ) -> Callable[[DistH2Data, torch.Tensor], SolveResult]:
    """``fn(d, b) -> SolveResult`` solving ``(shift*I + A) x = b`` on this
    rank's shard.

    ``method``: ``"pcg"`` | ``"gmres"`` (b: [n_local]) or ``"block_cg"``
    (b: [n_local, nv], every RHS in one solve).  ``x`` comes back as the
    rank's rows; every scalar and the history are equal on all ranks.
    ``hide_flops`` requests the solver-embedded matvec lowering (merged
    single-round exchange, hide-aware auto schedule -- ``core.dist``).
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected {METHODS}")
    bind = _operator(dshape, comm, mode, shift, schedule, backend,
                     hide_flops)

    def fn(d: DistH2Data, b: torch.Tensor) -> SolveResult:
        apply_a = bind(d)
        if method == "pcg":
            return pcg(apply_a, b, tol=tol, maxiter=maxiter, comm=comm)
        if method == "block_cg":
            return block_cg(apply_a, b, tol=tol, maxiter=maxiter, comm=comm)
        return gmres(apply_a, b, m=restart, tol=tol, maxiter=maxiter,
                     comm=comm)
    return fn


def krylov_comm_bytes(dshape: DistH2Shape, nv: int = 1,
                      mode: str = "halo-plan",
                      bytes_per_el: int = 4) -> int:
    """Per-rank bytes received by ONE Krylov iteration on the plain H^2
    operator: the matvec exchange plus the psum'd scalar reductions (CG:
    three scalars per iteration, each gathered from the other ranks)."""
    psums = 3 * nv * bytes_per_el * max(dshape.p - 1, 0)
    return matvec_comm_bytes(dshape, nv, mode, bytes_per_el) + psums
