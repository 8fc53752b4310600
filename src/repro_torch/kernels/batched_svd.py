"""Batched one-sided Jacobi SVD on the card (``csrc/batched_svd.cu``).

Replaces the Pallas kernel ``repro/kernels/batched_svd.py:batched_svd``:
Brent-Luk parallel order, Frobenius-normalized input, exit one confirming
sweep after the off-diagonal Gram norm falls below ``tol`` (tested per
matrix) or after ``max_sweeps``, sigma sorted descending.  Gram-based
Jacobi in fp32 cannot resolve the mutual angles of columns whose sigmas sit far below sigma_max (graded spectra with ratios
of 1e-7 reach the recompression upsweep), so U is polished with one pass
of the QR kernel: its columns become orthonormal while ``A - U S V^T``
stays O(eps * sigma_max).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .batched_qr import batched_qr

LAUNCHES = 0

_P, _L, _I = _build.P, _build.L, _build.I
_SIGNATURES = {
    "batched_svd_smem_bytes": ([_I, _I], _L),
    "batched_svd_f32": ([_P, _L, _L, _L, _P, _P, _P, _I, _I, _I, _I,
                         ctypes.c_float, _P], _I),
}


def batched_svd(a: torch.Tensor, *, max_sweeps: int = 15, tol: float = 1e-6
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A ``[B, n, k]`` -> (U ``[B, n, kn]``, sigma ``[B, kn]``,
    V^T ``[B, kn, k]``), kn = min(n, k) -- ``torch.linalg.svd`` shapes."""
    global LAUNCHES
    if not a.is_cuda:
        raise ValueError("batched_svd kernel takes CUDA tensors")
    if a.dtype != torch.float32 or a.dim() != 3:
        raise ValueError(f"batched_svd kernel takes float32 [B, n, k], got "
                         f"{a.dtype} {tuple(a.shape)}")
    nb, n, k = a.shape
    kn = min(n, k)
    if 0 in (nb, n, k):
        return (torch.zeros((nb, n, kn), dtype=a.dtype, device=a.device),
                torch.zeros((nb, kn), dtype=a.dtype, device=a.device),
                torch.zeros((nb, kn, k), dtype=a.dtype, device=a.device))
    lib = _build.load("batched_svd", _SIGNATURES)
    need = lib.batched_svd_smem_bytes(n, k)
    if need > lib.repro_max_dynamic_smem():
        raise ValueError(f"batched_svd: a [{n} x {k}] matrix needs {need} "
                         "bytes of shared memory, more than one block has")
    u = torch.empty((nb, n, kn), dtype=a.dtype, device=a.device)
    s = torch.empty((nb, kn), dtype=a.dtype, device=a.device)
    vt = torch.empty((nb, kn, k), dtype=a.dtype, device=a.device)
    err = lib.batched_svd_f32(
        _build.ptr(a), *a.stride(), _build.ptr(u), _build.ptr(s),
        _build.ptr(vt), nb, n, k, max_sweeps, tol, _build.stream_of(a))
    LAUNCHES += 1
    _build.check(lib, err, "batched_svd")
    return batched_qr(u)[0], s, vt
