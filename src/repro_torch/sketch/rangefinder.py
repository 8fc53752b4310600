"""Level-by-level randomized rangefinder -> nested H^2 bases.

Input: per-level block-row sketches ``Y_l[t] = A(t, F_l(t)) Omega`` (from
``sample.sample_block_rows`` or the black-box prober).  Output: an
orthonormal *nested* basis tree (leaf bases + transfer matrices) in the
``H2Data`` layout, with per-level ranks chosen from the sketch spectrum.

Construction is the upsweep dual of the recompression in
``core/compression.py``:

- leaf level: stack each leaf's restriction of every coupling level's
  sketch side by side -> candidate ``B_i = [Y_depth|_i, ..., Y_lmin|_i]``;
  QR, then the SVD of the small R factor orders the columns by singular
  value, giving the truncated leaf basis ``U_i``.
- inner level ``l-1``: project the coarser levels' sketch columns into the
  children's coordinates (``C = U^T B``), stack the two children, and QR/SVD
  again -> transfer matrices ``E`` (so the explicit bases stay orthonormal
  by construction) and the next level's projected sketches.

The R factors are wide: a leaf's ``R`` is ``[m, R_q]`` with ``R_q`` the sum
of every coupling level's budget (hundreds of columns), more than the
SVD kernel's shared memory takes.  Only U and sigma are needed, so a wide
``r`` (p < R) is reduced first: ``r^T = Q2 r2`` (R only, ``[R, p] -> [p,
p]``) gives ``r = r2^T Q2^T``, whose U and sigma are those of the small
square ``r2^T``.  Both backends take this composition, so the plain path
runs the same algorithm; the bases equal the reference's up to column
signs and rounding, the ranks and the operator are the same.

Rank selection runs on the host (one sync per pick), as in the reference.
``backend="cuda"`` runs the QRs and SVDs on the hand-written kernels
(``kernels/batched_qr.py``, ``kernels/batched_svd.py``) for CUDA tensors.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops as kops


def _u_sigma(r: torch.Tensor, backend: str
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """U ``[nn, p, p]`` and sigma ``[nn, p]`` of ``r [nn, p, R]``; a wide
    ``r`` goes through the R factor of its transpose."""
    p, cols = r.shape[-2:]
    if p < cols:
        r = kops.backend_qr_r(r.transpose(-1, -2), backend).transpose(-1, -2)
    u, s, _ = kops.backend_svd(r, backend, want_vt=False)
    return u, s


def orthonormal_basis(b: torch.Tensor, backend: str = "cuda"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Orthonormalize sketch stacks, columns ordered by singular value.

    b: [nn, rows, R] -> (basis [nn, rows, p], svals [nn, p]) with
    p = min(rows, R); ``basis[..., :k]`` is the best rank-k sketch basis.
    """
    q, r = kops.backend_qr(b, backend)
    u, s = _u_sigma(r, backend)
    return torch.matmul(q, u), s


def sketch_spectrum(y: torch.Tensor, backend: str = "cuda") -> torch.Tensor:
    """Singular values of each node's sketch -- the residual estimator.

    The trailing singular values of ``Y = A Omega`` estimate the trailing
    spectrum of the sampled block row (Halko/Martinsson/Tropp): if
    ``sigma_j(Y) > tol * scale`` for all j up to the sample budget, the
    sketch is *saturated* and more samples are needed.  Only sigma is
    read, so the SVD skips V^T and the polish of U.
    """
    r = kops.backend_qr_r(y, backend)
    return kops.backend_svd(r, backend, want_vt=False, polish=False)[1]


def pick_rank(svals: torch.Tensor, thresh: float, cap: int) -> int:
    """max over nodes of #{sigma > thresh}, clamped to [1, cap] (host)."""
    k = int((svals > thresh).sum(dim=-1).max())
    return max(1, min(k, cap))


def _truncate_project(basis: torch.Tensor, b: torch.Tensor, rank: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    u = basis[..., :rank]
    return u, torch.matmul(u.transpose(-1, -2), b)


def build_nested_bases(sketches: Sequence[Optional[torch.Tensor]],
                       leaf_size: int, tol: float, max_rank: int,
                       backend: str = "cuda"
                       ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                  Tuple[int, ...]]:
    """Sketches -> (u_leaf [2**q, m, k_q], transfers e[0..q], ranks).

    ``sketches[l]`` is ``[2**l, w_l, r_l]`` (or None when level ``l`` has no
    coupling blocks).  Transfer conventions match ``core.structure.H2Data``:
    ``e[l]: [2**l, k_l, k_{l-1}]``, explicit ``U^{l-1}|_c = U_c^l E_c``.
    Levels above the topmost coupling level get rank 0 (zero-size
    transfers); the matvec sweeps carry zeros through them.
    """
    depth = len(sketches) - 1
    m = leaf_size

    # column budget per level, coarse-to-fine concat order (prefix = coarser)
    widths = [0 if sketches[l] is None else int(sketches[l].shape[-1])
              for l in range(depth + 1)]
    col_end = [sum(widths[:l + 1]) for l in range(depth + 1)]
    if col_end[depth] == 0:
        raise ValueError("no coupling levels to sketch")

    parts = [sketches[l].reshape(1 << depth, m, widths[l])
             for l in range(depth + 1) if widths[l]]
    b = torch.cat(parts, dim=-1)                         # [2**q, m, R_q]

    basis, s = orthonormal_basis(b, backend)
    thresh = tol * float(s.max())
    ranks = [0] * (depth + 1)
    ranks[depth] = pick_rank(s, thresh, min(max_rank, int(s.shape[-1])))
    u_leaf, c = _truncate_project(basis, b, ranks[depth])

    e: List[Optional[torch.Tensor]] = [None] * (depth + 1)
    e[0] = b.new_zeros((0, 0, 0))
    for l in range(depth, 0, -1):
        nn = 1 << l
        kl = ranks[l]
        r_par = col_end[l - 1]                           # columns of levels < l
        if r_par == 0:                                   # top of coupling range
            ranks[l - 1] = 0
            e[l] = b.new_zeros((nn, kl, 0))
            c = b.new_zeros((nn // 2, 0, 0))
            continue
        stack = c[:, :, :r_par].reshape(nn // 2, 2 * kl, r_par)
        basis, s = orthonormal_basis(stack, backend)
        cap = min(max_rank, 2 * kl, r_par)
        ranks[l - 1] = pick_rank(s, thresh, cap)
        g, c = _truncate_project(basis, stack, ranks[l - 1])
        e[l] = g.reshape(nn, kl, ranks[l - 1]).contiguous()
    return u_leaf.contiguous(), e, tuple(ranks)


def explicit_bases(u_leaf: torch.Tensor, e: Sequence[torch.Tensor]
                   ) -> List[torch.Tensor]:
    """Expand nested bases to explicit per-level bases (the device analogue
    of ``core.reconstruct.explicit_bases``): exp[l]: [2**l, w_l, k_l]."""
    depth = len(e) - 1
    exp: List[Optional[torch.Tensor]] = [None] * (depth + 1)
    exp[depth] = u_leaf
    for l in range(depth, 0, -1):
        ue = torch.matmul(exp[l], e[l])
        nn, w, kp = ue.shape
        exp[l - 1] = ue.reshape(nn // 2, 2 * w, kp)
    return exp
