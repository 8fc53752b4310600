"""Basis orthogonalization (paper §5.2, last paragraphs).

Upsweep of batched QR: leaf bases are QR-factorized; at inner levels the
stacked (R_child @ E_child) pairs are QR-factorized to produce orthonormal
transfer matrices.  The per-level R factors re-express the coupling blocks:
``S'_ts = Ru_t @ S_ts @ Rv_s^T``.

After this pass, ``V^l_s{}^T V^l_s = I`` at every level — the precondition of
the compression downsweep (paper Eq. 4).  A symmetric operator whose two
trees are one (``v_leaf is u_leaf``) is factored once and stays aliased.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.obs.trace import phase

from .structure import H2Data, H2Shape, remarshal


def orthogonalize_tree(leaf: torch.Tensor, transfers: List[torch.Tensor],
                       backend: str = "cuda"
                       ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                  List[torch.Tensor]]:
    """Orthogonalize one basis tree.

    Returns (new_leaf, new_transfers, r_factors) where ``r_factors[l]`` maps
    the old rank-k_l coordinates to the new orthonormal ones: old = new @ R.
    """
    depth = len(transfers) - 1
    r: List[torch.Tensor] = [None] * (depth + 1)
    q_leaf, r[depth] = kops.backend_qr(leaf, backend)
    new_tr: List[torch.Tensor] = [transfers[0]] + [None] * depth
    for l in range(depth, 0, -1):
        re = torch.matmul(r[l], transfers[l])               # R_c @ E_c
        nn, kl, klm1 = re.shape
        stacked = re.reshape(nn // 2, 2 * kl, klm1)
        q, rr = kops.backend_qr(stacked, backend)
        new_tr[l] = q.reshape(nn, kl, q.shape[-1])
        r[l - 1] = rr
    return q_leaf, new_tr, r


def project_couplings(shape: H2Shape, data: H2Data,
                      left: List[torch.Tensor], right: List[torch.Tensor]
                      ) -> List[torch.Tensor]:
    """``S'_b = left[row_b] @ S_b @ right[col_b]^T`` at every level."""
    s_new = []
    for l in range(shape.depth + 1):
        if shape.coupling_counts[l] == 0:
            s_new.append(data.u_leaf.new_zeros(
                (0, left[l].shape[-2], right[l].shape[-2])))
            continue
        pl = left[l][data.s_rows[l].long()]
        pr = right[l][data.s_cols[l].long()]
        s_new.append(torch.matmul(torch.matmul(pl, data.s[l]),
                                  pr.transpose(-1, -2)))
    return s_new


def orthogonalize(shape: H2Shape, data: H2Data, backend: str = "cuda"
                  ) -> H2Data:
    """Orthogonalize both basis trees and update the coupling blocks."""
    with phase("compress/orthogonalize"):
        u_leaf, e_new, ru = orthogonalize_tree(data.u_leaf, data.e, backend)
        if shape.symmetric and data.v_leaf is data.u_leaf:
            v_leaf, f_new, rv = u_leaf, e_new, ru
        else:
            v_leaf, f_new, rv = orthogonalize_tree(data.v_leaf, data.f,
                                                   backend)
    with phase("compress/project-s"):
        s_new = project_couplings(shape, data, ru, rv)
    # the structure (and so the plan) is unchanged; S values are new, so
    # the marshaled buffers are regathered from the plan
    with phase("compress/remarshal"):
        return remarshal(H2Data(
            u_leaf=u_leaf, v_leaf=v_leaf, e=e_new, f=f_new, s=s_new,
            s_rows=list(data.s_rows), s_cols=list(data.s_cols),
            dense=data.dense, d_rows=data.d_rows, d_cols=data.d_cols,
            plan=data.plan, dense_mar=data.dense_mar), dense=False)
