"""The work each phase of the port's H² operations needs, from the
operator's shapes alone, and its roofline on one H100.

Each phase's count is its algorithm's need: every input byte read once,
every output byte written once, and the operations of its products
(``2 m n k`` for each ``[m, k] @ [k, n]``) and factorizations.  So the
count is the same whatever implements the phase: the plain backend,
today's kernels or a later fused one.  The HGEMV's operations are a
frozen copy of the arithmetic of ``repro_torch.core.matvec.h2_matvec_flops``
(held to it by a test), extended to bytes and to each phase; the QR and
SVD operations are those of Golub and Van Loan's table of costs (Matrix
Computations, 4th ed., fig. 8.6.1), as the port's kernel table uses them.
A structure index costs 4 bytes per block row and column it names.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

#: Published peaks of one NVIDIA H100 SXM (data sheet, dense rates), which
#: assume its full power limit of 700 W: HBM3 bandwidth and float32
#: operations outside the tensor cores.
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12,
         "power_limit_w": 700.0, "card": "NVIDIA H100 SXM"}


class RooflineError(RuntimeError):
    """A share of the roofline above 1: the work is counted too high or the
    time leaves out part of it."""


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    bytes: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)


ZERO = Work(0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class OpShape:
    """The sizes of an H² operator that its work depends on."""

    n: int                          # rows
    leaf: int                       # points per leaf
    depth: int                      # leaf level; level l has 2**l nodes
    ranks: Tuple[int, ...]          # rank of each level 0..depth
    counts: Tuple[int, ...]         # coupling blocks of each level
    dense_count: int                # dense leaf blocks
    symmetric: bool = True          # one basis tree serves rows and columns

    def nodes(self, level: int) -> int:
        return 1 << level

    @property
    def leaves(self) -> int:
        return 1 << self.depth


def op_shape(u_leaf, e: Sequence, s: Sequence, dense, symmetric: bool
             ) -> OpShape:
    """The ``OpShape`` of an operator read from its arrays' shapes:
    ``u_leaf`` [leaves, m, k], ``e[l]`` [2**l, k_l, k_{l-1}], ``s[l]``
    [blocks, k_l, k_l], ``dense`` [blocks, m, m]."""
    depth = len(e) - 1
    ranks = [0] * (depth + 1)
    ranks[depth] = int(u_leaf.shape[-1])
    for l in range(depth, 0, -1):
        ranks[l - 1] = int(e[l].shape[-1])
    leaves, m = int(u_leaf.shape[0]), int(u_leaf.shape[1])
    return OpShape(n=leaves * m, leaf=m, depth=depth, ranks=tuple(ranks),
                   counts=tuple(int(t.shape[0]) for t in s),
                   dense_count=int(dense.shape[0]), symmetric=symmetric)


def hgemv_flops(sh: OpShape, nv: int) -> int:
    """Operations of one HGEMV: ``h2_matvec_flops``'s arithmetic."""
    fl = 0
    m, q = sh.leaf, sh.depth
    kq = sh.ranks[q]
    fl += 2 * sh.leaves * m * kq * nv * 2
    for l in range(1, q + 1):
        fl += 2 * sh.nodes(l) * sh.ranks[l] * sh.ranks[l - 1] * nv * 2
    for l in range(q + 1):
        fl += 2 * sh.counts[l] * sh.ranks[l] ** 2 * nv
    fl += 2 * sh.dense_count * m * m * nv
    return fl


def hgemv_phases(sh: OpShape, nv: int, itemsize: int = 4
                 ) -> Dict[str, Work]:
    """Work of each phase of one HGEMV (``hgemv/upsweep``,
    ``hgemv/coupling-gemm``, ``hgemv/downsweep``, ``hgemv/dense``), each
    reading its inputs once and writing its outputs once.  The four
    operations add up to ``hgemv_flops``."""
    m, q, b = sh.leaf, sh.depth, itemsize
    k = sh.ranks
    vec = lambda l: sh.nodes(l) * k[l] * nv          # noqa: E731
    # upsweep: V^T x at the leaves, F^T at every inner level
    up = Work(2.0 * sh.leaves * m * k[q] * nv,
              b * (sh.leaves * m * k[q] + sh.n * nv + vec(q)))
    for l in range(q, 0, -1):
        up += Work(2.0 * sh.nodes(l) * k[l] * k[l - 1] * nv,
                   b * (sh.nodes(l) * k[l] * k[l - 1] + vec(l - 1)))
    # coupling: S of every level against xhat, into yhat
    cp = ZERO
    for l in range(q + 1):
        if sh.counts[l] and k[l]:
            cp += Work(2.0 * sh.counts[l] * k[l] ** 2 * nv,
                       b * (sh.counts[l] * k[l] ** 2 + 2 * vec(l))
                       + 8.0 * sh.counts[l])
    # downsweep: E of every level, then U at the leaves, into y
    dn = Work(0.0, b * vec(0))
    for l in range(1, q + 1):
        dn += Work(2.0 * sh.nodes(l) * k[l] * k[l - 1] * nv,
                   b * (sh.nodes(l) * k[l] * k[l - 1] + vec(l)))
    dn += Work(2.0 * sh.leaves * m * k[q] * nv,
               b * (sh.leaves * m * k[q] + sh.n * nv))
    # dense leaves against x, into y
    de = Work(2.0 * sh.dense_count * m * m * nv,
              b * (sh.dense_count * m * m + 2 * sh.n * nv)
              + 8.0 * sh.dense_count)
    return {"hgemv/upsweep": up, "hgemv/coupling-gemm": cp,
            "hgemv/downsweep": dn, "hgemv/dense": de}


def hgemv_call(sh: OpShape, nv: int, itemsize: int = 4) -> Work:
    """The least work of a whole HGEMV: the operator's arrays read once (one
    basis tree where rows and columns share it), ``x`` read once and ``y``
    written once, no intermediate counted: a bound that no fusion of the
    phases can beat."""
    m, q, b = sh.leaf, sh.depth, itemsize
    k = sh.ranks
    trees = 1 if sh.symmetric else 2
    arrays = trees * (sh.leaves * m * k[q] + sum(
        sh.nodes(l) * k[l] * k[l - 1] for l in range(1, q + 1)))
    arrays += sum(sh.counts[l] * k[l] ** 2 for l in range(q + 1))
    arrays += sh.dense_count * m * m
    idx = 8.0 * (sum(sh.counts) + sh.dense_count)
    return Work(float(hgemv_flops(sh, nv)),
                b * (arrays + 2 * sh.n * nv) + idx)


# ---------------------------------------------------------------------------
# recompression
# ---------------------------------------------------------------------------

def qr_flops(batch: int, rows: int, cols: int, want_q: bool = True) -> float:
    """Householder QR of ``batch`` [rows, cols] matrices, with the thin Q
    formed when ``want_q``."""
    kn = min(rows, cols)
    one = 2.0 * rows * cols * kn - 2.0 * kn ** 3 / 3.0
    return batch * one * (2 if want_q else 1)


def svd_flops(batch: int, rows: int, cols: int, want_vt: bool = True
              ) -> float:
    """A thin SVD of ``batch`` [rows, cols] matrices, the fewer operations
    of Golub-Reinsch and R-SVD; with ``want_vt=False`` sigma and U only."""
    m, s = max(rows, cols), min(rows, cols)
    if want_vt:
        one = min(14 * m * s * s + 8 * s ** 3, 6 * m * s * s + 20 * s ** 3)
    elif rows >= cols:
        one = min(14 * m * s * s - 2 * s ** 3, 6 * m * s * s + 11 * s ** 3)
    else:
        one = min(4 * m * s * s + 8 * s ** 3, 2 * m * s * s + 11 * s ** 3)
    return batch * float(one)


def mm(batch: int, m: int, k: int, n: int) -> float:
    return 2.0 * batch * m * k * n


def orthogonalize_work(sh: OpShape, itemsize: int = 4) -> Work:
    """``compress/orthogonalize`` of one basis tree (a symmetric operator
    has one): QR of the leaf bases, then per inner level ``R_c E_c`` and
    the QR of each parent's two stacked children.  Reads the leaf bases
    and transfers, writes the orthonormal ones and each level's R."""
    m, q, b = sh.leaf, sh.depth, itemsize
    k = sh.ranks
    trees = 1 if sh.symmetric else 2
    fl = qr_flops(sh.leaves, m, k[q])
    by = 2 * sh.leaves * m * k[q] + sh.leaves * k[q] ** 2
    for l in range(q, 0, -1):
        nn = sh.nodes(l)
        fl += mm(nn, k[l], k[l], k[l - 1])
        fl += qr_flops(nn // 2, 2 * k[l], k[l - 1])
        by += 2 * nn * k[l] * k[l - 1] + (nn // 2) * k[l - 1] ** 2
    return Work(trees * fl, trees * b * by)


def truncate_work(sh: OpShape, new_ranks: Sequence[int],
                  itemsize: int = 4) -> Work:
    """``compress/truncate`` of one basis tree to ``new_ranks`` (the ranks
    the tolerance picked): the leaf SVD of ``R^T`` and the truncated leaf
    basis, then per inner level the children's projected transfers
    stacked, weighted by the parent's R, factored by one SVD and
    projected.  Reads the orthonormal tree and the weights R, writes the
    truncated tree; the singular values go to the host."""
    m, q, b = sh.leaf, sh.depth, itemsize
    k, r = sh.ranks, list(new_ranks)
    trees = 1 if sh.symmetric else 2
    fl = svd_flops(sh.leaves, k[q], k[q], want_vt=False)
    fl += mm(sh.leaves, m, k[q], r[q])
    by = sh.leaves * (m * k[q] + k[q] ** 2 + m * r[q] + k[q])
    for l in range(q, 0, -1):
        nn = sh.nodes(l)
        fl += mm(nn, r[l], k[l], k[l - 1])              # P_c E_c
        fl += mm(nn // 2, 2 * r[l], k[l - 1], k[l - 1])  # stack R^T
        fl += svd_flops(nn // 2, 2 * r[l], k[l - 1], want_vt=False)
        fl += mm(nn // 2, r[l - 1], 2 * r[l], k[l - 1])  # G_k^T stack
        by += (nn * k[l] * k[l - 1] + (nn // 2) * k[l - 1] ** 2
               + nn * r[l] * r[l - 1] + (nn // 2) * min(2 * r[l], k[l - 1]))
    return Work(trees * fl, trees * b * by)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

def bound_seconds(w: Work, peaks: Dict = PEAKS) -> Tuple[float, str]:
    """The least time the card could take for ``w`` and what bounds it."""
    tb = w.bytes / peaks["hbm_bytes_per_s"]
    tf = w.flops / peaks["fp32_flops_per_s"]
    return (tb, "bytes") if tb >= tf else (tf, "flops")


def roofline(w: Work, seconds: float, peaks: Dict = PEAKS
             ) -> Tuple[float, str]:
    """Share of the roofline, in percent, of work ``w`` done in
    ``seconds`` of device time, and the bound it hit.  Over 100 raises."""
    if seconds <= 0:
        raise RooflineError(f"no device time for {w}")
    t, by = bound_seconds(w, peaks)
    share = 100.0 * t / seconds
    if share > 100.0:
        raise RooflineError(f"roofline share {share:.2f} % above 100 "
                            f"(bound {t:.6g} s by {by}, measured "
                            f"{seconds:.6g} s): the count is too high or "
                            f"the time misses work")
    return share, by
