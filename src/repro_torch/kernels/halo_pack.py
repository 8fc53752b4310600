"""Send-row packing of the halo exchange on the card (``csrc/halo_pack.cu``).

Replaces the Pallas kernel ``repro/kernels/halo_pack.py:halo_pack``:
``y[i] = x[idx[i]]`` over ``[k, nv]`` rows, written into a fresh buffer or
straight into a slice of the caller's send buffer (``out=``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

LAUNCHES = 0

_SIGNATURES = {"halo_pack_f32": ([_build.P, _build.P, _build.P, _build.I,
                                  _build.L, _build.P], _build.I)}


def halo_pack(x: torch.Tensor, idx: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-> packed ``[cap, *x.shape[1:]]``.

    x: ``[n, k, nv]`` float32 rows in node order; idx: ``[cap]`` int32
    planned send rows (padding entries may repeat row 0); out: optional
    contiguous float32 destination of the packed shape (for instance a
    view of a flat send buffer).  CUDA tensors only.
    """
    global LAUNCHES
    cap = idx.shape[0]
    shape = (cap, *x.shape[1:])
    tensors = (x, idx) if out is None else (x, idx, out)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("halo_pack kernel takes CUDA tensors on one device")
    if x.dtype != torch.float32 or idx.dtype != torch.int32 or \
            idx.dim() != 1:
        raise ValueError(f"halo_pack takes float32 rows and a 1-D int32 "
                         f"index, got {x.dtype}, "
                         f"{idx.dtype}{tuple(idx.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("halo_pack kernel takes contiguous tensors")
    if out is None:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
    elif tuple(out.shape) != shape or out.dtype != torch.float32:
        raise ValueError(f"halo_pack out {tuple(out.shape)} {out.dtype}, "
                         f"expected {shape} float32")
    row = math.prod(x.shape[1:])
    if cap == 0 or row == 0:                  # nothing to copy: never launch
        return out
    lib = _build.load("halo_pack", _SIGNATURES)
    err = lib.halo_pack_f32(_build.ptr(x), _build.ptr(idx), _build.ptr(out),
                            cap, row, _build.stream_of(x))
    LAUNCHES += 1
    _build.check(lib, err, "halo_pack")
    return out
