"""Batched reduced Householder QR on the card (``csrc/batched_qr.cu``).

Replaces the Pallas kernel ``repro/kernels/batched_qr.py:batched_qr``.
Returns the unique sign-fixed form: ``Q [B, n, kn]``, ``R [B, kn, k]`` with
``kn = min(n, k)`` and a non-negative R diagonal.

``qr_plan`` picks the route from the shape alone (it needs no card, so the
CPU tests check it):

- ``"warp"``: short panels (n <= 128, k <= 64), one warp per matrix, Q and
  R or R only;
- ``"tall"``: R only for taller stacks (k <= 64): the rows stream through
  in chunks of 32, R <- R of [R; chunk];
- ``"general"``: one block per matrix, in shared memory when the matrix
  fits, else in a global scratch copy; also the route of small batches
  (fewer than ``MIN_BATCH`` matrices), where one warp's serial walk over a
  matrix is slower than a block's and the card has room for the block.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

ROUTES = ("warp", "tall", "general")
LAUNCHES = 0
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)   # LAUNCHES split by route
WARP_MAX_ROWS = 128
MAX_COLS = 64
TALL_CHUNK = 32                  # rows per chunk (TCH in the kernel)
MIN_BATCH = 512                  # fewer matrices: the general route is faster
SMEM_LIMIT = 232448              # H100: dynamic shared memory of one block

_P, _L, _I = _build.P, _build.L, _build.I
_SIGNATURES = {
    "batched_qr_smem_bytes": ([_I, _I, _I], _L),
    "batched_qr_f32": ([_P, _L, _L, _L, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "batched_qr_warp_floats": ([_I, _I, _I], _L),
    "batched_qr_tall_floats": ([_I], _L),
    "batched_qr_warp_f32": ([_P, _L, _L, _L, _P, _P, _I, _I, _I, _I, _I,
                             _P], _I),
    "batched_qr_tall_f32": ([_P, _L, _L, _L, _P, _I, _I, _I, _I, _P], _I),
}


def warp_bytes(n: int, k: int, want_q: bool) -> int:
    """Shared memory of one matrix on the warp route (``qr_warp_floats``):
    the tile and Q column by column (stride n|1), the reflectors' diagonal
    and alpha, rounded to 16 bytes."""
    kn = min(n, k)
    f = (k + (kn if want_q else 0)) * (n | 1) + 2 * kn
    return 4 * ((f + 3) & ~3)


def tall_bytes(k: int) -> int:
    """Shared memory of one matrix on the tall route (``qr_tall_floats``):
    two column-major chunks of ``TALL_CHUNK`` rows (column stride
    ``TALL_CHUNK + 4``) and R."""
    return 4 * (2 * k * (TALL_CHUNK + 4) + ((k * k + 3) & ~3))


def qr_plan(n: int, k: int, want_q: bool = True,
            smem_limit: int = SMEM_LIMIT, nb: Optional[int] = None) -> str:
    """The route ``batched_qr`` (``want_q``) or ``batched_qr_r`` takes for
    ``[nb, n, k]`` (a pure function of the shape, the Q request and the
    shared memory a block has; ``nb=None`` plans for a large batch)."""
    if k <= MAX_COLS and (nb is None or nb >= MIN_BATCH):
        if n <= WARP_MAX_ROWS and warp_bytes(n, k, want_q) <= smem_limit:
            return "warp"
        if not want_q and n >= k and tall_bytes(k) <= smem_limit:
            return "tall"
    return "general"


def _check(a: torch.Tensor) -> None:
    if not a.is_cuda:
        raise ValueError("batched_qr kernel takes CUDA tensors")
    if a.dtype != torch.float32 or a.dim() != 3:
        raise ValueError(f"batched_qr kernel takes float32 [B, n, k], got "
                         f"{a.dtype} {tuple(a.shape)}")


def _launch(a: torch.Tensor, want_q: bool, route: Optional[str],
            force_global: bool = False
            ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    global LAUNCHES
    nb, n, k = a.shape
    kn = min(n, k)
    lib = _build.load("batched_qr", _SIGNATURES)
    limit = lib.repro_max_dynamic_smem()
    route = "general" if force_global else \
        (route or qr_plan(n, k, want_q, limit, nb))
    if route not in ROUTES:
        raise ValueError(f"unknown batched_qr route {route!r}")
    fits = qr_plan(n, k, want_q, limit)     # the route the shape allows
    if route not in ("general", fits):
        raise ValueError(f"batched_qr: route {route!r} cannot take "
                         f"[{n} x {k}] ({fits!r} can)")
    q = a.new_empty((nb, n, kn)) if want_q else None
    r = a.new_empty((nb, kn, k))
    q_ptr = _build.ptr(q) if want_q else None
    stream = _build.stream_of(a)
    if route == "warp":
        wpb = _build.warps_per_block(warp_bytes(n, k, want_q), limit)
        err = lib.batched_qr_warp_f32(_build.ptr(a), *a.stride(), q_ptr,
                                      _build.ptr(r), nb, n, k, int(want_q),
                                      wpb, stream)
    elif route == "tall":
        wpb = _build.warps_per_block(tall_bytes(k), limit)
        err = lib.batched_qr_tall_f32(_build.ptr(a), *a.stride(),
                                      _build.ptr(r), nb, n, k, wpb, stream)
    else:
        need = lib.batched_qr_smem_bytes(n, k, int(want_q))
        work = None
        if force_global or need > limit:
            work = a.new_empty((nb, n, k))
        err = lib.batched_qr_f32(_build.ptr(a), *a.stride(), q_ptr,
                                 _build.ptr(r),
                                 _build.ptr(work) if work is not None
                                 else None,
                                 nb, n, k, int(want_q), stream)
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    _build.check(lib, err, "batched_qr")
    return q, r


def batched_qr(a: torch.Tensor, *, force_global: bool = False,
               route: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A ``[B, n, k]`` -> (Q ``[B, n, kn]``, R ``[B, kn, k]``).

    ``route`` overrides ``qr_plan`` (the batch-size rule included);
    ``force_global`` takes the general
    route's global-memory path even when the matrix fits in shared memory
    (the two paths are held to each other on the card).
    """
    _check(a)
    nb, n, k = a.shape
    kn = min(n, k)
    if 0 in (nb, n, k):
        return a.new_zeros((nb, n, kn)), a.new_zeros((nb, kn, k))
    return _launch(a, True, route, force_global)


def batched_qr_r(a: torch.Tensor, *, route: Optional[str] = None
                 ) -> torch.Tensor:
    """R factor only (Q is never formed): the warp route for short panels,
    the streamed tall route for taller stacks.  Equal to ``batched_qr``'s R
    up to rounding where A has full column rank (bitwise where both calls
    take the same route); for a rank-deficient A, R^T R = A^T A all the
    same."""
    _check(a)
    nb, n, k = a.shape
    if 0 in (nb, n, k):
        return a.new_zeros((nb, min(n, k), k))
    return _launch(a, False, route)[1]
