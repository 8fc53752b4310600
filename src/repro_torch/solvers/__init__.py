"""Krylov solver subsystem of the port: PCG / block-CG / restarted
GMRES(m) run as fixed-length segments (replayed from CUDA graphs on the
card, eagerly over a ``Comm``), the geometric-multigrid V-cycle
preconditioner (one device or row-strip sharded) and the distributed
Krylov builders over the block-row H^2 stack."""
from .distributed import (krylov_comm_bytes, make_dist_krylov,
                          make_dist_krylov_segment)
from .graphs import SegmentRunner
from .krylov import (PCGState, SolveResult, STATUS_BREAKDOWN,
                     STATUS_INDEFINITE, STATUS_NAN, STATUS_OK,
                     STATUS_STAGNATION, TRACE_COUNTS, block_cg, gmres,
                     guards_enabled, pcg, pcg_init, pcg_segment,
                     set_guards_enabled)
from .mg import (GridMG, MGArrays, build_grid_mg, mg_halo_bytes,
                 mg_local_shard, mg_precond_local, solver_hide_flops)

__all__ = [
    "SolveResult", "TRACE_COUNTS", "pcg", "block_cg", "gmres",
    "PCGState", "pcg_init", "pcg_segment",
    "STATUS_OK", "STATUS_NAN", "STATUS_INDEFINITE", "STATUS_STAGNATION",
    "STATUS_BREAKDOWN", "guards_enabled", "set_guards_enabled",
    "GridMG", "MGArrays", "build_grid_mg", "mg_precond_local",
    "mg_local_shard", "mg_halo_bytes", "solver_hide_flops",
    "SegmentRunner", "make_dist_krylov", "make_dist_krylov_segment",
    "krylov_comm_bytes",
]
