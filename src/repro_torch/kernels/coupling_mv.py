"""Plan-driven block-sparse MV on the card (``csrc/coupling_mv.cu``).

Replaces the Pallas kernel ``repro/kernels/coupling_mv.py:coupling_mv``:
``y[r] = sum_{j < cnt[r]} s[blk[r*maxb+j]] @ x[col[r*maxb+j]]`` with S and x
in natural layout, one writer per row, padding slots skipped.

``cmv_plan`` picks the route from the shape alone (it needs no card, so the
CPU tests check it):

- ``"warp16"`` (nv a multiple of 16) and ``"warp1"`` (nv = 1): the
  pipelined ring kernel, k1, k2 <= 64.  A warp (or a part of one) owns one
  block row's tile of y, each lane ``rows x columns`` of it in fp32
  registers (``FMA_TILES``); the next slot's S and x are copied into the
  warp's own two-stage shared-memory ring while the current one is
  multiplied, with no block barrier;
- ``"general"``: the first kernel, for every other shape (k > 64, nv
  neither 1 nor a multiple of 16).

The configuration ``kb`` (rows of a tile's bucket) is fixed at compile
time: the smallest that holds k1 rows (the largest, in several row tiles,
where none does); while the grid has fewer than ``SPLIT_BELOW`` items, the
next smaller one, down to ``MIN_SPLIT_ROWS``-row tiles, so that a small
level's rows are shared by more warps (each walks the same slots over
fewer rows).
``vec`` says whether S is copied in 16-byte pieces (k2 % 4 == 0 and S
16-byte aligned).
"""
from __future__ import annotations

import functools
from array import array
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build

ROUTES = ("warp16", "warp1", "general")
_CODES = {"general": 0, "warp16": 1, "warp1": 2}
LAUNCHES = 0
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)   # LAUNCHES split by route
MAX_K = 64
SPLIT_BELOW = 1536      # items (~12 resident warps x 132 SMs): split rows
MIN_SPLIT_ROWS = 8      # ... down to tiles of 8 rows
# (route, kb) -> (SUB lanes an item, G column groups, RPL rows a lane, CW
# columns a lane) of a tile; ``coupling_mv_ring`` in the source
# instantiates the same table
FMA_TILES = {
    ("warp16", 4): (16, 4, 1, 4), ("warp16", 8): (32, 4, 1, 4),
    ("warp16", 16): (32, 4, 2, 4), ("warp16", 40): (32, 4, 5, 4),
    ("warp16", 64): (32, 4, 4, 4),
    ("warp1", 8): (8, 1, 1, 1), ("warp1", 16): (16, 1, 1, 1),
    ("warp1", 32): (32, 1, 1, 1),
}

_SIGNATURES = {"coupling_mv_f32": ([_build.P], _build.I)}
_FN = None


class CmvPlan(NamedTuple):
    route: str
    kb: Optional[int] = None       # configuration (the pipelined routes)
    vec: bool = False              # 16-byte copies of S


def row_tile(route: str, kb: int) -> int:
    """Rows of y one item of configuration ``(route, kb)`` holds."""
    sub, g, rpl, _ = FMA_TILES[(route, kb)]
    return sub // g * rpl


def col_tile(route: str, kb: int) -> int:
    """Columns of y one item of configuration ``(route, kb)`` holds."""
    _, g, _, cw = FMA_TILES[(route, kb)]
    return g * cw


def items(route: str, kb: int, rows: int, k1: int, nv: int) -> int:
    """Items (block row, row tile, column tile) of the kernel's grid."""
    return rows * -(-k1 // row_tile(route, kb)) * (nv // col_tile(route, kb))


def fits(route: str, k1: int, k2: int, nv: int) -> bool:
    """Whether ``route`` can take the shape (a forced route must)."""
    if route == "general":
        return True
    if min(k1, k2, nv) <= 0 or max(k1, k2) > MAX_K:
        return False
    return nv == 1 if route == "warp1" else nv % 16 == 0


@functools.lru_cache(maxsize=256)
def cmv_plan(rows: int, k1: int, k2: int, nv: int, maxb: int,
             aligned: bool = True, route: Optional[str] = None) -> CmvPlan:
    """The route ``coupling_mv`` takes for S ``[., k1, k2]``, x ``[., k2,
    nv]`` and a ``rows x maxb`` slot plan (``aligned``: S starts on a
    16-byte boundary); ``route`` asks for a route that ``fits`` and plans
    its configuration.  A pure function of its arguments."""
    if route is None:
        if min(rows, maxb) <= 0:
            route = "general"
        else:
            route = "warp1" if nv == 1 else "warp16"
        if not fits(route, k1, k2, nv):
            route = "general"
    if route == "general":
        return CmvPlan("general")
    buckets = sorted(b for (rt, b) in FMA_TILES if rt == route)
    i = min((i for i, b in enumerate(buckets) if b >= k1),
            default=len(buckets) - 1)     # more rows: several row tiles
    while buckets[i] > MIN_SPLIT_ROWS and \
            items(route, buckets[i], rows, k1, nv) < SPLIT_BELOW:
        i -= 1
    return CmvPlan(route, buckets[i], aligned and k2 % 4 == 0)


def owner_counts(plan: CmvPlan, rows: int, k1: int, nv: int) -> np.ndarray:
    """How many lanes of the pipelined kernel's grid store each output
    ``y[r, i, v]`` (``[rows, k1, nv]``), by the kernel's own index
    arithmetic over global warps (the same for any warps a block): every
    entry is 1 when each output has exactly one owner."""
    sub, groups, rpl, cw = FMA_TILES[(plan.route, plan.kb)]
    tile, nvt = row_tile(plan.route, plan.kb), col_tile(plan.route, plan.kb)
    row_tiles, nv_tiles = -(-k1 // tile), nv // nvt
    n = items(plan.route, plan.kb, rows, k1, nv)
    t = np.arange(-(-n // (32 // sub)) * 32)           # lanes of the grid
    lane = t % 32
    item = t // 32 * (32 // sub) + lane // sub
    sl, item = (lane % sub)[item < n], item[item < n]
    nt, rest = item % nv_tiles, item // nv_tiles
    rt, r = rest % row_tiles, rest // row_tiles
    lanes_r = sub // groups
    g, ll = sl % groups, sl // groups
    counts = np.zeros((rows, k1, nv), np.int64)
    for i in range(rpl):
        for c in range(cw):
            row, v = rt * tile + ll + i * lanes_r, nt * nvt + g * cw + c
            keep = row < k1
            np.add.at(counts, (r[keep], row[keep], v[keep]), 1)
    return counts


def coupling_mv(s: torch.Tensor, x: torch.Tensor, blk: torch.Tensor,
                col: torch.Tensor, cnt: torch.Tensor, *, maxb: int,
                route: Optional[str] = None) -> torch.Tensor:
    """-> y ``[rows, k1, nv]``.

    s: ``[nb, k1, k2]`` blocks; x: ``[nodes, k2, nv]`` source vectors;
    blk/col: ``[rows*maxb]`` int32 slot plan (padding blk == nb);
    cnt: ``[rows]`` int32 blocks per row.  CUDA tensors only.  ``route``
    overrides ``cmv_plan``'s choice with a route that ``fits`` the shape
    (its configuration still planned); one that does not fit raises.  The
    HGEMV makes 13 of these calls, most of them small, so the launch's
    arguments go to the card packed into one int64 array (one ctypes
    argument).
    """
    global LAUNCHES, _FN
    dev = s.get_device()
    if not (s.is_cuda and x.get_device() == dev and blk.get_device() == dev
            and col.get_device() == dev and cnt.get_device() == dev):
        raise ValueError("coupling_mv kernel takes CUDA tensors on one device")
    if s.dtype is not torch.float32 or x.dtype is not torch.float32:
        raise ValueError("coupling_mv kernel takes float32 blocks/vectors")
    if blk.dtype is not torch.int32 or col.dtype is not torch.int32 or \
            cnt.dtype is not torch.int32:
        raise ValueError("coupling_mv plan arrays must be int32")
    if not (s.is_contiguous() and x.is_contiguous() and blk.is_contiguous()
            and col.is_contiguous() and cnt.is_contiguous()):
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
    ps = s.data_ptr()
    if route is not None and (route not in ROUTES or
                              not fits(route, k1, k2, nv)):
        raise ValueError(f"coupling_mv: route {route!r} cannot take k1={k1} "
                         f"k2={k2} nv={nv}")
    plan = cmv_plan(rows, k1, k2, nv, maxb, ps % 16 == 0, route)
    route = plan.route
    y = torch.empty((rows, k1, nv), dtype=s.dtype, device=s.device)
    if _FN is None:
        _FN = _build.load("coupling_mv", _SIGNATURES).coupling_mv_f32
    args = array("q", (_CODES[route], ps, x.data_ptr(), blk.data_ptr(),
                       col.data_ptr(), cnt.data_ptr(), y.data_ptr(), rows,
                       nb, k1, k2, nv, maxb, plan.kb or 0, int(plan.vec),
                       _build.raw_stream(s)))
    err = _FN(args.buffer_info()[0])
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    if err:
        _build.check(_build.load("coupling_mv", _SIGNATURES), err,
                     f"coupling_mv ({route})")
    return y
