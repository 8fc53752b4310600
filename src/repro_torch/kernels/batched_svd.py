"""Batched one-sided Jacobi SVD on the card (``csrc/batched_svd.cu``).

Replaces the Pallas kernel ``repro/kernels/batched_svd.py:batched_svd``:
Brent-Luk parallel order, Frobenius-normalized input, exit one confirming
sweep after the off-diagonal Gram norm falls below ``tol`` (tested per
matrix) or after ``max_sweeps``, sigma sorted descending.  Gram-based
Jacobi in fp32 cannot resolve the mutual angles of columns whose sigmas
sit far below sigma_max (graded spectra with ratios of 1e-7 reach the
recompression upsweep), so on the routes where U = A / sigma, U is
polished with one pass of the QR kernel: its columns become orthonormal
while ``A - U S V^T`` stays O(eps * sigma_max).

``svd_plan`` picks the route from the shape alone (it needs no card, so
the CPU tests check it):

- ``"warp"``: one warp per matrix, Jacobi on the k columns (n >= k);
- ``"warp_t"``: one warp per matrix, Jacobi on the n columns of A^T
  (n < k, the wide panels of the truncation sweep); U is the accumulated
  rotation, orthonormal by construction, so no polish;
- ``"general"``: one block per matrix, for more than 64 Jacobi columns or
  columns longer than ``WARP_MAX_ROWS``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .batched_qr import batched_qr

ROUTES = ("warp", "warp_t", "general")
LAUNCHES = 0
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)   # LAUNCHES split by route
WARP_MAX_COLS = 64          # one Brent-Luk pair per lane
WARP_MAX_ROWS = 256         # a lane's serial loop over a column
SMEM_LIMIT = 232448         # H100: dynamic shared memory one block may use

_P, _L, _I = _build.P, _build.L, _build.I
_SIGNATURES = {
    "batched_svd_smem_bytes": ([_I, _I], _L),
    "batched_svd_f32": ([_P, _L, _L, _L, _P, _P, _P, _I, _I, _I, _I,
                         ctypes.c_float, _P], _I),
    "batched_svd_warp_floats": ([_I, _I, _I], _L),
    "batched_svd_warp_f32": ([_P, _L, _L, _L, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, ctypes.c_float, _P], _I),
}


def _col_stride(rows: int) -> int:
    """``col_stride`` of the kernel: rows rounded up to an odd number of
    16-byte units."""
    return 4 * (((rows + 3) >> 2) | 1)


def warp_bytes(n: int, k: int, want_vt: bool) -> int:
    """Shared memory of one matrix on the warp route (``svd_warp_floats``
    in the kernel): the Jacobi matrix column by column, V when it is
    accumulated, sigma and the order, rounded to 16 bytes."""
    trans = n < k
    rows, cols = (k, n) if trans else (n, k)
    ce = cols + (cols & 1)
    f = ce * _col_stride(rows) + \
        (ce * _col_stride(ce) if trans or want_vt else 0) + 2 * ce
    return 4 * ((f + 3) & ~3)


def general_bytes(n: int, k: int) -> int:
    """Shared memory of one matrix on the general route
    (``batched_svd_smem_bytes`` in the kernel): the matrix and V with a
    padded column each, sigma and the order, and a reduction scratch."""
    ke = k + (k & 1)
    return 4 * (n * (ke + 1) + ke * (ke + 1) + 2 * ke + 32)


def svd_plan(n: int, k: int, want_vt: bool = True,
             smem_limit: int = SMEM_LIMIT) -> str:
    """The route ``batched_svd`` takes for ``[*, n, k]`` (a pure function
    of the shape, the V^T request and the shared memory a block has)."""
    rows, cols = (k, n) if n < k else (n, k)
    if cols + (cols & 1) <= WARP_MAX_COLS and rows <= WARP_MAX_ROWS and \
            warp_bytes(n, k, want_vt) <= smem_limit:
        return "warp_t" if n < k else "warp"
    return "general"


def batched_svd(a: torch.Tensor, *, max_sweeps: int = 15, tol: float = 1e-6,
                want_vt: bool = True, route: Optional[str] = None,
                polish: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """A ``[B, n, k]`` -> (U ``[B, n, kn]``, sigma ``[B, kn]``,
    V^T ``[B, kn, k]``), kn = min(n, k) -- ``torch.linalg.svd`` shapes.

    ``want_vt=False`` returns None for V^T (the square routes then do not
    accumulate V).  ``route`` overrides ``svd_plan`` (to hold the routes to
    each other); a route that cannot take the shape raises.
    ``polish=False`` skips the QR polish of U (for a caller that reads
    sigma alone)."""
    global LAUNCHES
    if not a.is_cuda:
        raise ValueError("batched_svd kernel takes CUDA tensors")
    if a.dtype != torch.float32 or a.dim() != 3:
        raise ValueError(f"batched_svd kernel takes float32 [B, n, k], got "
                         f"{a.dtype} {tuple(a.shape)}")
    nb, n, k = a.shape
    kn = min(n, k)
    if 0 in (nb, n, k):
        return (a.new_zeros((nb, n, kn)), a.new_zeros((nb, kn)),
                a.new_zeros((nb, kn, k)) if want_vt else None)
    lib = _build.load("batched_svd", _SIGNATURES)
    limit = lib.repro_max_dynamic_smem()
    plan = svd_plan(n, k, want_vt, limit)
    route = route or plan
    if route not in ROUTES:
        raise ValueError(f"unknown batched_svd route {route!r}")
    if route != "general" and route != plan:
        raise ValueError(f"batched_svd: route {route!r} cannot take "
                         f"[{n} x {k}] (plan: {plan!r})")
    u = a.new_empty((nb, n, kn))
    s = a.new_empty((nb, kn))
    vt = a.new_empty((nb, kn, k)) if want_vt else None
    vt_ptr = _build.ptr(vt) if want_vt else None
    if route == "general":
        need = general_bytes(n, k)
        if need > limit:
            raise ValueError(f"batched_svd: a [{n} x {k}] matrix needs "
                             f"{need} bytes of shared memory, more than one "
                             "block has")
        err = lib.batched_svd_f32(
            _build.ptr(a), *a.stride(), _build.ptr(u), _build.ptr(s),
            vt_ptr, nb, n, k, max_sweeps, tol, _build.stream_of(a))
    else:
        wpb = _build.warps_per_block(warp_bytes(n, k, want_vt), limit)
        err = lib.batched_svd_warp_f32(
            _build.ptr(a), *a.stride(), _build.ptr(u), _build.ptr(s),
            vt_ptr, nb, n, k, int(want_vt), wpb, max_sweeps, tol,
            _build.stream_of(a))
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    _build.check(lib, err, "batched_svd")
    if route == "warp_t" or not polish:
        return u, s, vt
    return batched_qr(u)[0], s, vt
