"""On-device randomized-sketch construction of an H^2 matrix.

Pipeline (batched device work; the host runs only the tree / admissibility
setup and the integer rank picks, one sync each):

1. ``sample``     -- per coupling level, block-row sketches
                     ``Y_l[t] = A(t, F_l(t)) Omega`` with counter-based
                     Gaussians (sketch/rng.py), evaluated by chunked batched
                     kernel application (sketch/sample.py).  *Adaptive
                     oversampling*: start with a small sample budget and
                     double it while the sketch spectrum says the budget
                     saturates (all singular values above the tolerance),
                     up to ``max_rank + oversample``.
2. ``rangefinder``-- nested orthonormal bases + per-level ranks from the
                     sketches (sketch/rangefinder.py).
3. ``project``    -- coupling blocks ``S = U^T A V`` by chunked batched
                     kernel application against the explicit bases.
4. ``dense``      -- inadmissible leaf blocks, evaluated in chunks.

Each step runs under a ``phase`` (``sketch/sample-r<budget>``,
``sketch/spectrum``, ``sketch/rangefinder``, ``sketch/project``,
``sketch/dense``), so ``obs.trace.phase_times`` splits a construction.

Sampling evaluates every admissible block's entries once per round, so
construction work is O(C_sp N^2 / 2^lmin) kernel evaluations per round --
embarrassingly batched device work with O(N (r + k)) memory.  The
black-box mode (sketch/blackbox.py) replaces steps 1, 3 and 4 with probes
of a fast matvec.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.admissibility import (BlockStructure,
                                            build_block_structure)
from repro_torch.core.clustering import ClusterTree, build_cluster_tree
from repro_torch.core.structure import (CouplingPlan, H2Data, H2Shape,
                                        build_coupling_plan, remarshal)
from repro_torch.obs.trace import phase

from . import rng
from .rangefinder import (build_nested_bases, explicit_bases, pick_rank,
                          sketch_spectrum)
from .sample import (eval_dense_blocks, project_coupling_blocks,
                     sample_block_rows)

Sketches = List[Optional[torch.Tensor]]


def adaptive_sketches(sample_fn: Callable[[int], Sketches], tol: float,
                      max_rank: int, oversample: int,
                      n_samples0: Optional[int] = None,
                      backend: str = "cuda") -> Tuple[Sketches, int]:
    """Sample with a growing budget until the sketch resolves the spectrum.

    ``sample_fn(r)`` returns per-level sketches with ``r`` columns each.
    A level is *saturated* when its sketch still has ``> r - oversample``
    singular values above ``tol * scale`` -- i.e. the trailing-singular-value
    residual estimate cannot certify the tolerance -- in which case the
    budget is doubled, capped at ``max_rank + oversample``.
    Returns (sketches, n_samples_used).
    """
    r_cap = max_rank + oversample
    r = min(n_samples0 or (min(max_rank, 16) + oversample), r_cap)
    while True:
        with phase(f"sketch/sample-r{r}"):
            sketches = sample_fn(r)
        with phase("sketch/spectrum"):
            spectra = [sketch_spectrum(y, backend) for y in sketches
                       if y is not None and y.shape[0] > 0]
            if not spectra:             # no coupling levels: nothing to adapt
                return sketches, r
            scale = max(float(s.max()) for s in spectra)
            needed = max(pick_rank(s, tol * scale, r) for s in spectra)
        if needed <= max(r - oversample, 1) or r >= r_cap:
            return sketches, r
        r = min(2 * r, r_cap)


def _rank0_bases(depth: int, leaf_size: int, dtype, device
                 ) -> Tuple[torch.Tensor, List[torch.Tensor], Tuple[int, ...]]:
    """Empty basis tree for an operator with no admissible blocks."""
    u_leaf = torch.zeros((1 << depth, leaf_size, 0), dtype=dtype,
                         device=device)
    e = [u_leaf.new_zeros((0, 0, 0))] + [
        u_leaf.new_zeros((1 << l, 0, 0)) for l in range(1, depth + 1)]
    return u_leaf, e, tuple([0] * (depth + 1))


def _assemble(tree: ClusterTree, bs: BlockStructure, u_leaf, e, ranks,
              s_list, dense, plan: Optional[CouplingPlan] = None
              ) -> Tuple[H2Shape, H2Data]:
    """Package bases/couplings/dense into (H2Shape, H2Data) on
    ``u_leaf``'s device (one shared basis tree: ``v_leaf is u_leaf``)."""
    depth = tree.depth
    device = u_leaf.device

    def i32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32,
                               device=device)

    if plan is None:
        plan = build_coupling_plan(depth, bs.s_rows, bs.s_cols,
                                   bs.d_rows, bs.d_cols, device)
    data = remarshal(H2Data(
        u_leaf=u_leaf, v_leaf=u_leaf, e=list(e), f=list(e),
        s=list(s_list), s_rows=[i32(r) for r in bs.s_rows],
        s_cols=[i32(c) for c in bs.s_cols], dense=dense,
        d_rows=i32(bs.d_rows), d_cols=i32(bs.d_cols), plan=plan))
    shape = H2Shape(
        n=tree.n, leaf_size=tree.leaf_size, depth=depth, ranks=tuple(ranks),
        coupling_counts=bs.coupling_counts(),
        dense_count=int(bs.d_rows.shape[0]), symmetric=True,
        row_maxb=bs.row_maxb(), col_maxb=bs.col_maxb(),
        dense_maxb=int(plan.dblk.shape[0]) >> depth)
    return shape, data


def _check_kernel(kernel: Callable, d: int, dtype, device) -> None:
    """Fail early with a pointer when ``kernel`` does not take and return
    torch tensors (a numpy kernel, say)."""
    x = torch.zeros((1, 1, d), dtype=dtype, device=device)
    hint = ("method='sketch' needs a kernel on torch tensors; build it with "
            "repro_torch.core.kernels_fn, e.g. exponential_kernel(l)")
    try:
        out = kernel(x, x)
    except (TypeError, RuntimeError) as exc:
        raise TypeError(hint) from exc
    if not isinstance(out, torch.Tensor):
        raise TypeError(hint)


def sketch_construct(points: np.ndarray, kernel: Callable, leaf_size: int,
                     eta: float, *, tol: float = 1e-4, max_rank: int = 64,
                     oversample: int = 10, n_samples0: Optional[int] = None,
                     seed: int = 0, min_level: int = 1, dtype=torch.float32,
                     backend: str = "cuda", chunk: int = 256, device="cuda"
                     ) -> Tuple[H2Shape, H2Data, ClusterTree, BlockStructure]:
    """Randomized on-device H^2 construction of the kernel matrix.

    ``kernel`` takes torch tensors (``repro_torch.core.kernels_fn``); the
    points and every evaluation are in ``dtype`` on ``device``.  Matches the
    return signature of ``construct_h2``; the bases are orthonormal by
    construction.
    """
    device = torch.device(device)
    tree = build_cluster_tree(points, leaf_size, device)
    bs = build_block_structure(tree, eta, min_level=min_level)
    depth = tree.depth
    n = tree.n
    pts = torch.as_tensor(tree.points, device=device).to(dtype)
    _check_kernel(kernel, pts.shape[-1], dtype, device)
    counts = bs.coupling_counts()
    # one marshaling plan drives the sampler's block-row reductions here
    # and the matvec/compression dispatch of the assembled operator
    plan = build_coupling_plan(depth, bs.s_rows, bs.s_cols,
                               bs.d_rows, bs.d_cols, device)
    sr = [torch.as_tensor(bs.s_rows[l], dtype=torch.int32, device=device)
          for l in range(depth + 1)]
    sc = [torch.as_tensor(bs.s_cols[l], dtype=torch.int32, device=device)
          for l in range(depth + 1)]

    def sample_fn(r: int) -> Sketches:
        out: Sketches = []
        for l in range(depth + 1):
            if counts[l] == 0:
                out.append(None)
                continue
            nn = 1 << l
            w = n >> l
            omega = rng.level_gaussians(seed, l, nn, w, r, dtype, device)
            out.append(sample_block_rows(
                pts.reshape(nn, w, -1), sr[l], sc[l], omega, plan.sblk[l],
                kernel=kernel, chunk=chunk))
        return out

    if sum(counts) == 0:
        # degenerate all-dense H^2 (shallow tree / tight eta): rank-0 bases
        u_leaf, e, ranks = _rank0_bases(depth, leaf_size, dtype, device)
    else:
        sketches, _ = adaptive_sketches(sample_fn, tol, max_rank, oversample,
                                        n_samples0, backend)
        with phase("sketch/rangefinder"):
            u_leaf, e, ranks = build_nested_bases(sketches, leaf_size, tol,
                                                  max_rank, backend)
        del sketches
    u_exp = explicit_bases(u_leaf, e)

    s_list = []
    with phase("sketch/project"):
        for l in range(depth + 1):
            if counts[l] == 0:
                s_list.append(pts.new_zeros((0, ranks[l], ranks[l])))
                continue
            nn = 1 << l
            s_list.append(project_coupling_blocks(
                pts.reshape(nn, n >> l, -1), sr[l], sc[l], u_exp[l],
                u_exp[l], kernel=kernel, chunk=chunk))
    del u_exp

    with phase("sketch/dense"):
        dense = eval_dense_blocks(
            pts.reshape(1 << depth, leaf_size, -1),
            torch.as_tensor(bs.d_rows, dtype=torch.int32, device=device),
            torch.as_tensor(bs.d_cols, dtype=torch.int32, device=device),
            kernel=kernel).to(dtype)

    shape, data = _assemble(tree, bs, u_leaf, e, ranks, s_list, dense,
                            plan=plan)
    return shape, data, tree, bs
