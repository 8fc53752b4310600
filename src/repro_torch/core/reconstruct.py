"""Dense reconstruction of an H^2 matrix (tests/validation only, O(N^2)).

Host numpy in float64, like the reference; tensors are copied off the
device first.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .structure import H2Data, H2Shape


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def explicit_bases(shape_depth: int, leaf: np.ndarray,
                   transfers: List[np.ndarray]) -> List[np.ndarray]:
    """Expand nested bases into explicit per-level bases.

    Returns list over levels l=0..depth of arrays [2**l, n>>l, k_l].
    """
    depth = shape_depth
    out: List[np.ndarray] = [None] * (depth + 1)
    out[depth] = leaf
    for l in range(depth, 0, -1):
        ue = np.einsum("cwk,ckp->cwp", out[l], transfers[l])
        nn, w, kp = ue.shape
        out[l - 1] = ue.reshape(nn // 2, 2 * w, kp)
    return out


def reconstruct_dense(shape: H2Shape, data: H2Data) -> np.ndarray:
    """A = A_de + sum over levels/blocks of U_t S_ts V_s^T (numpy)."""
    n, m = shape.n, shape.leaf_size
    u = explicit_bases(shape.depth, _np(data.u_leaf), [_np(e) for e in data.e])
    v = explicit_bases(shape.depth, _np(data.v_leaf), [_np(f) for f in data.f])
    a = np.zeros((n, n))
    for l in range(shape.depth + 1):
        if shape.coupling_counts[l] == 0:
            continue
        w = n >> l
        rows = _np(data.s_rows[l]).astype(np.int64)
        cols = _np(data.s_cols[l]).astype(np.int64)
        s = _np(data.s[l])
        for b in range(rows.shape[0]):
            t, c = int(rows[b]), int(cols[b])
            a[t * w:(t + 1) * w, c * w:(c + 1) * w] += u[l][t] @ s[b] @ v[l][c].T
    dr = _np(data.d_rows).astype(np.int64)
    dc = _np(data.d_cols).astype(np.int64)
    de = _np(data.dense)
    for b in range(dr.shape[0]):
        t, c = int(dr[b]), int(dc[b])
        a[t * m:(t + 1) * m, c * m:(c + 1) * m] += de[b]
    return a


def check_orthogonal(shape: H2Shape, data: H2Data, tol: float = 1e-4) -> float:
    """Max deviation of V^T V from identity across all levels (``tol`` is
    kept for signature compatibility; the caller compares the result)."""
    worst = 0.0
    for leaf, tr in ((data.u_leaf, data.e), (data.v_leaf, data.f)):
        bases = explicit_bases(shape.depth, _np(leaf), [_np(t) for t in tr])
        for l in range(shape.depth + 1):
            b = bases[l]
            if b.shape[-1] == 0:
                continue
            gram = np.einsum("cwk,cwj->ckj", b, b)
            eye = np.eye(gram.shape[-1])[None]
            worst = max(worst, float(np.abs(gram - eye).max()))
    return worst
