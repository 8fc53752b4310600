"""Batched reduced Householder QR on the card (``csrc/batched_qr.cu``).

Replaces the Pallas kernel ``repro/kernels/batched_qr.py:batched_qr``.
Returns the unique sign-fixed form: ``Q [B, n, kn]``, ``R [B, kn, k]`` with
``kn = min(n, k)`` and a non-negative R diagonal.  A matrix that fits in
shared memory is factored there; a larger one in a global scratch copy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

LAUNCHES = 0

_P, _L, _I = _build.P, _build.L, _build.I
_SIGNATURES = {
    "batched_qr_smem_bytes": ([_I, _I, _I], _L),
    "batched_qr_f32": ([_P, _L, _L, _L, _P, _P, _P, _I, _I, _I, _I, _P], _I),
}


def _check(a: torch.Tensor) -> None:
    if not a.is_cuda:
        raise ValueError("batched_qr kernel takes CUDA tensors")
    if a.dtype != torch.float32 or a.dim() != 3:
        raise ValueError(f"batched_qr kernel takes float32 [B, n, k], got "
                         f"{a.dtype} {tuple(a.shape)}")


def _launch(a: torch.Tensor, want_q: bool, force_global: bool
            ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    global LAUNCHES
    nb, n, k = a.shape
    kn = min(n, k)
    q = torch.empty((nb, n, kn), dtype=a.dtype, device=a.device) \
        if want_q else None
    r = torch.empty((nb, kn, k), dtype=a.dtype, device=a.device)
    lib = _build.load("batched_qr", _SIGNATURES)
    need = lib.batched_qr_smem_bytes(n, k, int(want_q))
    work = None
    if force_global or need > lib.repro_max_dynamic_smem():
        work = torch.empty((nb, n, k), dtype=a.dtype, device=a.device)
    err = lib.batched_qr_f32(_build.ptr(a), *a.stride(),
                             _build.ptr(q) if want_q else None, _build.ptr(r),
                             _build.ptr(work) if work is not None else None,
                             nb, n, k, int(want_q), _build.stream_of(a))
    LAUNCHES += 1
    _build.check(lib, err, "batched_qr")
    return q, r


def batched_qr(a: torch.Tensor, *, force_global: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A ``[B, n, k]`` -> (Q ``[B, n, kn]``, R ``[B, kn, k]``).

    ``force_global`` takes the global-memory path even when the matrix fits
    in shared memory (the two paths are held to each other on the card).
    """
    _check(a)
    nb, n, k = a.shape
    kn = min(n, k)
    if 0 in (nb, n, k):
        return (torch.zeros((nb, n, kn), dtype=a.dtype, device=a.device),
                torch.zeros((nb, kn, k), dtype=a.dtype, device=a.device))
    return _launch(a, True, force_global)


def batched_qr_r(a: torch.Tensor) -> torch.Tensor:
    """R factor only (Q is never formed); the same R as ``batched_qr``."""
    _check(a)
    nb, n, k = a.shape
    if 0 in (nb, n, k):
        return torch.zeros((nb, min(n, k), k), dtype=a.dtype, device=a.device)
    return _launch(a, False, False)[1]
