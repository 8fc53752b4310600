"""Plan-driven block-sparse MV on the card (``csrc/coupling_mv.cu``).

Replaces the Pallas kernel ``repro/kernels/coupling_mv.py:coupling_mv``:
``y[r] = sum_{j < cnt[r]} s[blk[r*maxb+j]] @ x[col[r*maxb+j]]`` with S and x
in natural layout, one writer per row, padding slots skipped.
"""
from __future__ import annotations

import torch

from . import _build

LAUNCHES = 0

_SIGNATURES = {"coupling_mv_f32": ([_build.P] * 6 + [_build.I] * 6 +
                                   [_build.P], _build.I)}


def coupling_mv(s: torch.Tensor, x: torch.Tensor, blk: torch.Tensor,
                col: torch.Tensor, cnt: torch.Tensor, *, maxb: int
                ) -> torch.Tensor:
    """-> y ``[rows, k1, nv]``.

    s: ``[nb, k1, k2]`` blocks; x: ``[nodes, k2, nv]`` source vectors;
    blk/col: ``[rows*maxb]`` int32 slot plan (padding blk == nb);
    cnt: ``[rows]`` int32 blocks per row.  CUDA tensors only.
    """
    global LAUNCHES
    tensors = (s, x, blk, col, cnt)
    if not all(t.is_cuda and t.device == s.device for t in tensors):
        raise ValueError("coupling_mv kernel takes CUDA tensors on one device")
    if s.dtype != torch.float32 or x.dtype != torch.float32:
        raise ValueError("coupling_mv kernel takes float32 blocks/vectors")
    if any(t.dtype != torch.int32 for t in (blk, col, cnt)):
        raise ValueError("coupling_mv plan arrays must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("coupling_mv kernel takes contiguous tensors")
    nb, k1, k2 = s.shape
    nv = x.shape[-1]
    rows = cnt.shape[0]
    if x.dim() != 3 or x.shape[1] != k2 or blk.shape[0] != rows * maxb or \
            col.shape[0] != rows * maxb:
        raise ValueError(f"coupling_mv shapes s{tuple(s.shape)} "
                         f"x{tuple(x.shape)} blk{tuple(blk.shape)} "
                         f"rows={rows} maxb={maxb}")
    if 0 in (rows, k1, nv, k2, nb, maxb):   # nothing to add: never launch
        return torch.zeros((rows, k1, nv), dtype=s.dtype, device=s.device)
    y = torch.empty((rows, k1, nv), dtype=s.dtype, device=s.device)
    lib = _build.load("coupling_mv", _SIGNATURES)
    err = lib.coupling_mv_f32(_build.ptr(s), _build.ptr(x), _build.ptr(blk),
                              _build.ptr(col), _build.ptr(cnt), _build.ptr(y),
                              rows, nb, k1, k2, nv, maxb, _build.stream_of(s))
    LAUNCHES += 1
    _build.check(lib, err, "coupling_mv")
    return y
