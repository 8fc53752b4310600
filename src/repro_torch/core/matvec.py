"""H^2 matrix-(multi)vector product: upsweep, coupling multiply, downsweep.

Single-device version (paper §3, Algorithms 1/4/6).  Every tree level is one
batched contraction.  ``backend`` selects the implementation:

  - "cuda":  the hand-written kernels on CUDA tensors (plain versions on
             CPU tensors).  The dense contractions use ``batched_gemm``,
             reading the transposed bases in place; the block-sparse phases
             (coupling per level, dense leaves) use the plan-driven
             ``coupling_mv`` on S's natural layout.
  - "torch": plain PyTorch: batched einsums, and the block-sparse phases as
             one plan gather + one batched product against the
             row-marshaled buffers (the reference's "jnp" path).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.obs.trace import phase

from .structure import H2Data, H2Shape


def _bgemm(a: torch.Tensor, b: torch.Tensor, backend: str) -> torch.Tensor:
    """Batched [B,m,k] @ [B,k,n] -> [B,m,n]."""
    return kops.batched_gemm(a, b, backend)


def upsweep(shape: H2Shape, data: H2Data, x_leaves: torch.Tensor,
            backend: str = "cuda") -> List[torch.Tensor]:
    """xhat[l] = V^T x at every level.  x_leaves: [2**depth, m, nv]."""
    depth = shape.depth
    xhat: List[Optional[torch.Tensor]] = [None] * (depth + 1)
    xhat[depth] = _bgemm(data.v_leaf.transpose(-1, -2), x_leaves, backend)
    for l in range(depth, 0, -1):
        klm1 = shape.ranks[l - 1]
        nn = shape.nodes(l)
        nv = xhat[l].shape[-1]
        # children-to-parent: xhat^{l-1}_t = sum_c F_c^T xhat^l_c
        contrib = _bgemm(data.f[l].transpose(-1, -2), xhat[l], backend)
        xhat[l - 1] = contrib.reshape(nn // 2, 2, klm1, nv).sum(dim=1)
    return xhat


def marshaled_multiply(blocks_mar: torch.Tensor, x: torch.Tensor,
                       col: torch.Tensor, backend: str = "torch"
                       ) -> torch.Tensor:
    """One marshaled block-sparse MV: ``y_r = sum_j B[r, j] x[col[r, j]]``.

    ``blocks_mar``: [rows, k1, maxb*k2] row-marshaled blocks (zero padding),
    ``x``: [nodes, k2, nv], ``col``: [rows*maxb] slot plan.  The slot
    reduction rides the product's contraction.
    """
    rows, _, mk2 = blocks_mar.shape
    nv = x.shape[-1]
    xg = x[col.long()].reshape(rows, mk2, nv)
    return _bgemm(blocks_mar, xg, backend)


def coupling_multiply(shape: H2Shape, data: H2Data,
                      xhat: List[torch.Tensor], backend: str = "cuda"
                      ) -> List[torch.Tensor]:
    """yhat[l] = S^l xhat[l] — a block-sparse MV at every level."""
    depth = shape.depth
    nv = xhat[depth].shape[-1]
    yhat: List[torch.Tensor] = []
    for l in range(depth + 1):
        nn = shape.nodes(l)
        kl = shape.ranks[l]
        if shape.coupling_counts[l] == 0 or kl == 0:
            yhat.append(xhat[depth].new_zeros((nn, kl, nv)))
            continue
        if backend == "cuda":
            maxb = data.plan.sblk[l].shape[0] // nn
            yhat.append(kops.coupling_mv(
                data.s[l], xhat[l], data.plan.sblk[l], data.plan.scol[l],
                data.plan.scnt[l], maxb=maxb, backend=backend))
        else:
            yhat.append(marshaled_multiply(data.s_mar[l], xhat[l],
                                           data.plan.scol[l], backend))
    return yhat


def downsweep(shape: H2Shape, data: H2Data, yhat: List[torch.Tensor],
              backend: str = "cuda") -> torch.Tensor:
    """Accumulate yhat down the U tree; returns y_leaves [2**depth, m, nv]."""
    acc = yhat[0]
    for l in range(1, shape.depth + 1):
        par = acc.repeat_interleave(2, dim=0)            # [2**l, k_{l-1}, nv]
        acc = yhat[l] + _bgemm(data.e[l], par, backend)  # [2**l, k_l, nv]
    return _bgemm(data.u_leaf, acc, backend)             # [2**q, m, nv]


def dense_multiply(shape: H2Shape, data: H2Data, x_leaves: torch.Tensor,
                   backend: str = "cuda") -> torch.Tensor:
    """A_de x — block-sparse MV over the dense leaves."""
    if shape.dense_count == 0:
        return torch.zeros_like(x_leaves)
    if backend == "cuda":
        maxb = data.plan.dblk.shape[0] // shape.n_leaves
        return kops.coupling_mv(data.dense, x_leaves, data.plan.dblk,
                                data.plan.dcol, data.plan.dcnt, maxb=maxb,
                                backend=backend)
    return marshaled_multiply(data.dense_mar, x_leaves, data.plan.dcol,
                              backend)


def h2_matvec(shape: H2Shape, data: H2Data, x: torch.Tensor,
              backend: str = "cuda") -> torch.Tensor:
    """y = A x with A = A_de + <U,S,V^T>;  x: [N, nv] in tree order."""
    if backend not in kops.BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    nv = x.shape[-1]
    x_leaves = x.reshape(shape.n_leaves, shape.leaf_size, nv).contiguous()
    with phase("hgemv/upsweep"):
        xhat = upsweep(shape, data, x_leaves, backend)
    with phase("hgemv/coupling-gemm"):
        yhat = coupling_multiply(shape, data, xhat, backend)
    with phase("hgemv/downsweep"):
        y_lr = downsweep(shape, data, yhat, backend)
    with phase("hgemv/dense"):
        y_de = dense_multiply(shape, data, x_leaves, backend)
    return (y_lr + y_de).reshape(shape.n, nv)


def h2_matvec_flops(shape: H2Shape, nv: int) -> int:
    """Model FLOPs of one HGEMV (2*m*n*k per GEMM) — roofline numerator."""
    fl = 0
    m, q = shape.leaf_size, shape.depth
    kq = shape.ranks[q]
    fl += 2 * shape.n_leaves * m * kq * nv * 2          # leaf V^T x and U yhat
    for l in range(1, q + 1):
        fl += 2 * shape.nodes(l) * shape.ranks[l] * shape.ranks[l - 1] * nv * 2
    for l in range(q + 1):
        fl += 2 * shape.coupling_counts[l] * shape.ranks[l] ** 2 * nv
    fl += 2 * shape.dense_count * m * m * nv
    return fl
