"""Batched GEMM ``C[b] = A[b] @ B[b]`` on the card (``csrc/batched_gemm.cu``).

Replaces the Pallas kernel ``repro/kernels/batched_gemm.py:batched_gemm``.
A and B are read through their strides, so transposed views are not copied.
"""
from __future__ import annotations

import torch

from . import _build

LAUNCHES = 0

_P, _L, _I = _build.P, _build.L, _build.I
_SIGNATURES = {"batched_gemm_f32": ([_P, _L, _L, _L, _P, _L, _L, _L, _P,
                                     _I, _I, _I, _I, _P], _I)}


def batched_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[B, M, K] @ [B, K, N] -> [B, M, N]`` (fp32, CUDA tensors only)."""
    global LAUNCHES
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError("batched_gemm kernel takes CUDA tensors on one device")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"batched_gemm kernel takes float32, got "
                         f"{a.dtype}, {b.dtype}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or \
            a.shape[2] != b.shape[1]:
        raise ValueError(f"batched_gemm shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    nb, m, k = a.shape
    n = b.shape[2]
    if 0 in (nb, m, n, k):          # zero-size batch/dims: never launch
        return torch.zeros((nb, m, n), dtype=a.dtype, device=a.device)
    c = torch.empty((nb, m, n), dtype=a.dtype, device=a.device)
    lib = _build.load("batched_gemm", _SIGNATURES)
    err = lib.batched_gemm_f32(_build.ptr(a), *a.stride(), _build.ptr(b),
                               *b.stride(), _build.ptr(c), nb, m, n, k,
                               _build.stream_of(a))
    LAUNCHES += 1
    _build.check(lib, err, "batched_gemm")
    return c
