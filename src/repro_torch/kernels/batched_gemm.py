"""Batched GEMM ``C[b] = A[b] @ B[b]`` on the card (``csrc/batched_gemm.cu``).

Replaces the Pallas kernel ``repro/kernels/batched_gemm.py:batched_gemm``.
``plan_launch`` picks the kernel's path from shapes, strides and pointer
alignment alone (it needs no card, so the CPU tests check it):

- ``"bulk:<bucket>:<layout>"`` / ``"async:<bucket>:<layout>"``: the fast
  path, which stages each A[b] and B[b] whole as one flat span -- by the
  Hopper bulk copy where both spans are 16-byte aligned and 16-byte
  multiples, else by ``cp.async``; ``bucket`` is the M bucket (``m16``,
  ``m48``, ``m64``), ``layout`` how A lies in its span (``t``: a
  transposed view, ``n``: row-major, ``n4``: row-major with K % 4 == 0);
- ``"general"``: the strided kernel, for everything else;
- ``"zeros"``: a zero-size problem, which launches nothing.
"""
from __future__ import annotations

from array import array

import torch

from . import _build

LAUNCHES = 0

_SIGNATURES = {"batched_gemm_f32": ([_build.P], _build.I)}
_BUCKETS = ("m16", "m48", "m64")          # M <= 16, 48, 64
_LAYOUTS = ("t", "n", "n4")
# the kernel's plan codes (see batched_gemm_f32) and their names; -1
# launches nothing
PLAN_NAMES = {-1: "zeros", 0: "general"}
for _b, _bn in enumerate(_BUCKETS):
    for _l, _ln in enumerate(_LAYOUTS):
        for _bulk, _mode in enumerate(("async", "bulk")):
            PLAN_NAMES[1 + _bulk + 2 * _l + 6 * _b] = f"{_mode}:{_bn}:{_ln}"
_FN = None


def _plan_code(nb: int, m: int, k: int, n: int, sa, sb, pa: int,
               pb: int) -> int:
    """The path for ``[nb, m, k] @ [nb, k, n]`` with element strides
    ``sa``/``sb`` and data pointers ``pa``/``pb``, as the kernel's plan
    code (``PLAN_NAMES``).  The fast path needs every A[b] and B[b] dense:
    B row-major, A row-major or a transposed view (strides of size-1 dims
    do not matter); the bulk copy needs both spans 16-byte aligned and
    multiples of 16 bytes (K*N*4 is, as N % 4 == 0)."""
    if not (nb and m and k and n):
        return -1
    if m > 64 or k > 64 or n > 16 or n & 3:
        return 0
    if not ((nb == 1 or sb[0] == k * n) and (k == 1 or sb[1] == n) and
            sb[2] == 1):
        return 0
    dense = nb == 1 or sa[0] == m * k
    if dense and (m == 1 or sa[1] == k) and (k == 1 or sa[2] == 1):
        layout = 1 if k & 3 else 2
    elif dense and (m == 1 or sa[1] == 1) and (k == 1 or sa[2] == m):
        layout = 0
    else:
        return 0
    bucket = 0 if m <= 16 else 1 if m <= 48 else 2
    bulk = not ((m * k) & 3 or pa & 15 or pb & 15)
    return 1 + bulk + 2 * layout + 6 * bucket


def plan_launch(a: torch.Tensor, b: torch.Tensor) -> str:
    """The path ``batched_gemm`` takes for ``a [nb, M, K] @ b [nb, K, N]``
    (a pure function of shapes, strides and pointer alignment)."""
    nb, m, k = a.shape
    return PLAN_NAMES[_plan_code(nb, m, k, b.shape[2], a.stride(),
                                 b.stride(), a.data_ptr(), b.data_ptr())]


def batched_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[B, M, K] @ [B, K, N] -> [B, M, N]`` (fp32, CUDA tensors only).

    The HGEMV makes ~30 of these calls, most of them small, so the host
    side is kept to what the launch needs: one planning function, and the
    launch's arguments packed into one int64 array (one ctypes argument
    instead of fifteen conversions)."""
    global LAUNCHES, _FN
    if not (a.is_cuda and b.is_cuda) or a.get_device() != b.get_device():
        raise ValueError("batched_gemm kernel takes CUDA tensors on one device")
    if a.dtype is not torch.float32 or b.dtype is not torch.float32:
        raise ValueError(f"batched_gemm kernel takes float32, got "
                         f"{a.dtype}, {b.dtype}")
    ash, bsh = a.shape, b.shape
    if len(ash) != 3 or len(bsh) != 3 or ash[0] != bsh[0] or \
            ash[2] != bsh[1]:
        raise ValueError(f"batched_gemm shapes {tuple(ash)} @ {tuple(bsh)}")
    nb, m, k = ash
    n = bsh[2]
    sa, sb = a.stride(), b.stride()
    pa, pb = a.data_ptr(), b.data_ptr()
    code = _plan_code(nb, m, k, n, sa, sb, pa, pb)
    if code < 0:                             # zero-size batch/dims
        return a.new_zeros((nb, m, n))
    c = a.new_empty((nb, m, n))
    if _FN is None:
        _FN = _build.load("batched_gemm", _SIGNATURES).batched_gemm_f32
    args = array("q", (code, pa, sa[0], sa[1], sa[2], pb, sb[0], sb[1],
                       sb[2], c.data_ptr(), nb, m, n, k,
                       _build.raw_stream(a)))
    err = _FN(args.buffer_info()[0])
    LAUNCHES += 1
    if err:
        _build.check(_build.load("batched_gemm", _SIGNATURES), err,
                     f"batched_gemm ({PLAN_NAMES[code]})")
    return c
