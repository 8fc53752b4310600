"""Black-box H^2 construction from a matvec ``x -> A x`` (peeling probes).

Given only the *action* of an N x N **symmetric** operator (plus the point
geometry that fixes the tree and admissibility structure), build its H^2
representation: squaring an existing H^2 operator (``A = B @ B``),
re-compressing a sum of symmetric operators, or building preconditioner
factors from solvers.

Probing scheme (the levelwise variant of Lin-Lu-Ying peeling, batched):

- *Sketch probes* (per coupling level ``l``): the probe matrix carries an
  independent Gaussian block per tree node, supported on that node's rows
  only.  For an admissible pair ``(t, s)``, the rows of ``A @ probe``
  belonging to ``t`` in ``s``'s column group equal ``A(t,s) Omega_s``
  *exactly* -- dual-tree admissibility assigns each (t,s) interaction to
  exactly one level.  Summing over a block row (``index_add_``) gives the
  same ``Y_l[t]`` block-row sketches the geometric sampler builds.
- *Coupling probes*: the same node-supported probes loaded with the
  explicit column bases ``V_s`` give ``A(t,s) V_s`` exactly, hence
  ``S = U^T (A V)``.
- *Dense extraction*: identity probes colored over the leaf near-field
  graph (greedy coloring; same-colored leaves share no dense block row)
  applied to the *residual* ``A - A_lowrank`` (the port's ``h2_matvec``).

Cost: ``sum_l 2**l (r + k_l) + n_colors * m`` matvec columns, with dense
``[N, 2**l r]`` probes -- worthwhile when the matvec is fast (an existing
H^2 operator) and N is moderate.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.admissibility import (BlockStructure,
                                            build_block_structure)
from repro_torch.core.clustering import ClusterTree, build_cluster_tree
from repro_torch.core.matvec import h2_matvec
from repro_torch.core.structure import H2Data, H2Shape
from repro_torch.obs.trace import phase

from . import rng
from .construct import (Sketches, _assemble, _rank0_bases,
                        adaptive_sketches)
from .rangefinder import build_nested_bases, explicit_bases

SYMMETRY_STREAM = 10_000


def _node_probe(blocks: torch.Tensor) -> torch.Tensor:
    """Scatter per-node column blocks into a block-diagonal probe matrix.

    blocks: [nn, w, r] (node-supported columns) -> [nn*w, nn*r] with
    ``probe[s*w:(s+1)*w, s*r:(s+1)*r] = blocks[s]``.
    """
    nn, w, r = blocks.shape
    probe = blocks.new_zeros((nn * w, nn * r))
    idx = torch.arange(nn, device=blocks.device)
    probe.view(nn, w, nn, r)[idx, :, idx, :] = blocks
    return probe


def _gather_block_reads(z: torch.Tensor, nn: int, w: int, r: int,
                        s_rows: torch.Tensor, s_cols: torch.Tensor
                        ) -> torch.Tensor:
    """Read per-block results [nb, w, r] out of a probed matvec [n, nn*r]."""
    z4 = z.reshape(nn, w, nn, r)
    return z4[s_rows.long(), :, s_cols.long(), :]


def _leaf_coloring(d_rows: np.ndarray, d_cols: np.ndarray,
                   n_leaves: int) -> Tuple[np.ndarray, int]:
    """Greedy coloring of the leaf near-field graph.

    Two leaves conflict when some block row contains dense blocks to both --
    then identity probes for them must not share columns.  Degree is
    bounded by C_sp^2, so a handful of colors suffice.
    """
    groups: List[List[int]] = [[] for _ in range(n_leaves)]
    for t, s in zip(d_rows, d_cols):
        groups[int(t)].append(int(s))
    adj: List[Set[int]] = [set() for _ in range(n_leaves)]
    for members in groups:
        for a in members:
            for b in members:
                if a != b:
                    adj[a].add(b)
    color = np.full(n_leaves, -1, np.int64)
    for s in range(n_leaves):
        used = {color[t] for t in adj[s] if color[t] >= 0}
        c = 0
        while c in used:
            c += 1
        color[s] = c
    return color, int(color.max()) + 1


def _check_symmetric(matvec: Callable, n: int, seed: int, dtype,
                     device) -> None:
    """Two probe vectors on their own stream: ``<u, Av> == <v, Au>``."""
    uv = rng.node_gaussians(
        rng.stream_key(seed, SYMMETRY_STREAM),
        torch.zeros(1, dtype=torch.int64, device=device), rows=n, cols=2,
        dtype=dtype)[0]
    auv = matvec(uv)
    a = float(uv[:, 0] @ auv[:, 1])
    b = float(uv[:, 1] @ auv[:, 0])
    if abs(a - b) > 1e-3 * (abs(a) + abs(b) + 1e-30):
        raise ValueError(
            "construct_from_matvec supports symmetric operators only "
            f"(<u,Av>={a:.6g} != <v,Au>={b:.6g}); pass "
            "check_symmetry=False to override at your own risk")


def construct_from_matvec(matvec: Callable[[torch.Tensor], torch.Tensor],
                          points: np.ndarray, leaf_size: int, eta: float, *,
                          tol: float = 1e-4, max_rank: int = 64,
                          oversample: int = 10,
                          n_samples0: Optional[int] = None, seed: int = 0,
                          min_level: int = 1, dtype=torch.float32,
                          backend: str = "cuda", check_symmetry: bool = True,
                          device="cuda"
                          ) -> Tuple[H2Shape, H2Data, ClusterTree,
                                     BlockStructure]:
    """Build an H^2 representation of a black-box *symmetric* operator.

    ``matvec`` maps [N, nv] -> [N, nv] tensors on ``device`` in *tree
    (permuted) order* -- wrap with ``tree.perm`` if the operator lives in
    original order.  Geometry (``points``) fixes the tree/admissibility;
    entries come only from ``matvec``.  Return signature matches
    ``construct_h2``.

    Only block *rows* are probed and the row basis doubles as the column
    basis (``v_leaf is u_leaf``), so the operator must be symmetric: by
    default two probe vectors verify ``<u, Av> == <v, Au>`` and a
    ``ValueError`` is raised otherwise.
    """
    device = torch.device(device)
    tree = build_cluster_tree(points, leaf_size, device)
    bs = build_block_structure(tree, eta, min_level=min_level)
    n = tree.n
    if check_symmetry:
        _check_symmetric(matvec, n, seed, dtype, device)
    depth = tree.depth
    m = leaf_size
    counts = bs.coupling_counts()

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
            z = matvec(_node_probe(omega))
            y_b = _gather_block_reads(z, nn, w, r, sr[l], sc[l])
            out.append(omega.new_zeros((nn, w, r)).index_add_(
                0, sr[l].long(), y_b))
        return out

    if sum(counts) == 0:
        u_leaf, e, ranks = _rank0_bases(depth, m, dtype, device)
    else:
        sketches, _ = adaptive_sketches(sample_fn, tol, max_rank, oversample,
                                        n_samples0, backend)
        with phase("sketch/rangefinder"):
            u_leaf, e, ranks = build_nested_bases(sketches, m, tol,
                                                  max_rank, backend)
        del sketches
    u_exp = explicit_bases(u_leaf, e)

    # couplings: probe with the explicit column bases
    s_list = []
    with phase("sketch/project"):
        for l in range(depth + 1):
            if counts[l] == 0:
                s_list.append(u_leaf.new_zeros((0, ranks[l], ranks[l])))
                continue
            nn = 1 << l
            w = n >> l
            kl = ranks[l]
            z = matvec(_node_probe(u_exp[l]))
            av = _gather_block_reads(z, nn, w, kl, sr[l], sc[l])
            ut = u_exp[l][sr[l].long()]
            s_list.append(torch.bmm(ut.transpose(1, 2), av))
    del u_exp

    # dense leaves: colored identity probes against the low-rank residual
    with phase("sketch/dense"):
        shape_lr, data_lr = _assemble(
            tree, dataclasses.replace(bs, d_rows=np.zeros(0, np.int64),
                                      d_cols=np.zeros(0, np.int64)),
            u_leaf, e, ranks, s_list, u_leaf.new_zeros((0, m, m)))
        color_np, nc = _leaf_coloring(bs.d_rows, bs.d_cols, 1 << depth)
        color = torch.as_tensor(color_np, device=device)
        rows = torch.arange(n, device=device)
        probe = u_leaf.new_zeros((n, nc * m))
        probe[rows, color[rows // m] * m + rows % m] = 1.0
        zr = matvec(probe) - h2_matvec(shape_lr, data_lr, probe,
                                       backend=backend)
        del probe
        z4 = zr.reshape(1 << depth, m, nc, m)
        d_rows = torch.as_tensor(bs.d_rows, device=device)
        d_cols = torch.as_tensor(bs.d_cols, device=device)
        dense = z4[d_rows, :, color[d_cols], :].contiguous()

    shape, data = _assemble(tree, bs, u_leaf, e, ranks, s_list, dense)
    return shape, data, tree, bs
