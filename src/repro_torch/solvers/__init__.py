"""Krylov solver subsystem of the port: single-device PCG / block-CG /
restarted GMRES(m) run as fixed-length segments (replayed from CUDA graphs
on the card), and the geometric-multigrid V-cycle preconditioner."""
from .graphs import SegmentRunner
from .krylov import (PCGState, SolveResult, STATUS_BREAKDOWN,
                     STATUS_INDEFINITE, STATUS_NAN, STATUS_OK,
                     STATUS_STAGNATION, TRACE_COUNTS, block_cg, gmres,
                     guards_enabled, pcg, pcg_init, pcg_segment,
                     set_guards_enabled)
from .mg import GridMG, MGArrays, build_grid_mg, mg_precond_local

__all__ = [
    "SolveResult", "TRACE_COUNTS", "pcg", "block_cg", "gmres",
    "PCGState", "pcg_init", "pcg_segment",
    "STATUS_OK", "STATUS_NAN", "STATUS_INDEFINITE", "STATUS_STAGNATION",
    "STATUS_BREAKDOWN", "guards_enabled", "set_guards_enabled",
    "GridMG", "MGArrays", "build_grid_mg", "mg_precond_local",
    "SegmentRunner",
]
