"""Plain float64 products and checks of an H² operator read from its
arrays (in the tree order they are stored in).

The arrays are those of the paper's Table 1: leaf bases ``u_leaf``
[leaves, m, k], transfers ``e[l]`` [2**l, k_l, k_{l-1}], coupling blocks
``s[l]`` [blocks, k_l, k_l] at block rows ``s_rows[l]`` and columns
``s_cols[l]``, dense leaf blocks ``dense`` [blocks, m, m] at ``d_rows``,
``d_cols``; the column tree ``v_leaf``, ``f`` equals the row tree for a
symmetric operator.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _blocks(mat, rows, cols, x, out, chunk):
    """``out[rows[b]] += mat[b] @ x[cols[b]]`` over the blocks, in float64
    chunks."""
    for a in range(0, mat.shape[0], chunk):
        r, c = rows[a:a + chunk].long(), cols[a:a + chunk].long()
        out.index_add_(0, r, torch.matmul(mat[a:a + chunk].double(), x[c]))


def h2_apply(u_leaf, e: Sequence, s: Sequence, s_rows: Sequence,
             s_cols: Sequence, dense, d_rows, d_cols, x: torch.Tensor,
             v_leaf=None, f: Sequence = None, chunk: int = 8192
             ) -> torch.Tensor:
    """``y = (A_dense + U S V^T) x`` in float64; ``x`` [N, nv] in tree
    order."""
    v_leaf = u_leaf if v_leaf is None else v_leaf
    f = e if f is None else f
    depth = len(e) - 1
    nl, m, _ = u_leaf.shape
    nv = x.shape[-1]
    xl = x.double().reshape(nl, m, nv)
    xhat = [None] * (depth + 1)
    xhat[depth] = torch.matmul(v_leaf.double().transpose(-1, -2), xl)
    for l in range(depth, 0, -1):
        c = torch.matmul(f[l].double().transpose(-1, -2), xhat[l])
        xhat[l - 1] = c.reshape(c.shape[0] // 2, 2, *c.shape[1:]).sum(1)
    acc = None
    for l in range(depth + 1):
        y_l = torch.zeros_like(xhat[l])
        if s[l].shape[0]:
            _blocks(s[l], s_rows[l], s_cols[l], xhat[l], y_l, chunk)
        if acc is not None:
            y_l = y_l + torch.matmul(e[l].double(),
                                     acc.repeat_interleave(2, dim=0))
        acc = y_l
    y = torch.matmul(u_leaf.double(), acc)
    _blocks(dense, d_rows, d_cols, xl, y, chunk // 8)
    return y.reshape(nl * m, nv)


def basis_defect(u_leaf, e: Sequence) -> float:
    """The largest entry of ``Q^T Q - I`` over the leaf bases and every
    parent's two stacked child transfers: 0 for an orthonormal nested
    basis tree, whose every level's basis is then orthonormal too."""
    worst = 0.0
    q = u_leaf.double()
    eye = torch.eye(q.shape[-1], dtype=torch.float64, device=q.device)
    worst = max(worst, float((q.transpose(-1, -2) @ q - eye).abs().max()))
    for l in range(1, len(e)):
        t = e[l].double()
        nn, kl, kp = t.shape
        st = t.reshape(nn // 2, 2 * kl, kp)
        eye = torch.eye(kp, dtype=torch.float64, device=t.device)
        worst = max(worst, float((st.transpose(-1, -2) @ st - eye
                                  ).abs().max()))
    return worst


def node_basis(u_leaf, e: Sequence, level: int, node: int) -> torch.Tensor:
    """The explicit basis of ``node`` at ``level``, float64 [points under
    the node, k_level]: its leaves' bases times the transfers up to it."""
    depth = len(e) - 1
    span = 1 << (depth - level)
    b = u_leaf[node * span:(node + 1) * span].double()
    for l in range(depth, level, -1):
        first = node << (l - level)
        b = torch.matmul(b, e[l][first:first + b.shape[0]].double())
        b = b.reshape(b.shape[0] // 2, 2 * b.shape[1], b.shape[2])
    return b.reshape(-1, b.shape[-1])


def coupling_defect(u_leaf, e, s, s_rows, s_cols, pts_tree, kernel,
                    blocks: Sequence) -> float:
    """For the coupling blocks ``blocks`` (``(level, index)`` pairs), the
    relative Frobenius distance of ``S_b`` from ``U_t^T K(t, s) V_s``,
    taken over all of them: 0 in exact arithmetic for orthonormal bases
    and an exact kernel, the interpolation error of the construction
    otherwise.  ``pts_tree`` [N, dim] float64 in the operator's order."""
    depth = len(e) - 1
    m = u_leaf.shape[1]
    num = den = 0.0
    for level, b in blocks:
        t, c = int(s_rows[level][b]), int(s_cols[level][b])
        size = m << (depth - level)
        ut = node_basis(u_leaf, e, level, t)
        vc = node_basis(u_leaf, e, level, c)
        k = kernel(pts_tree[t * size:(t + 1) * size][:, None, :],
                   pts_tree[None, c * size:(c + 1) * size, :])
        want = ut.transpose(0, 1) @ k @ vc
        num += float(((s[level][b].double() - want) ** 2).sum())
        den += float((want ** 2).sum())
    return (num / den) ** 0.5 if den > 0 else float("inf")
