"""Send-row packing of the halo exchange on the card (``csrc/halo_pack.cu``).

Replaces the Pallas kernel ``repro/kernels/halo_pack.py:halo_pack``:
``y[i] = x[idx[i]]`` over ``[k, nv]`` rows.  The kernel packs a whole
table of such gathers -- a ``PackPlan`` of segments, each taking the rows
``idx`` of one source into its slice of one destination buffer -- in one
launch (``pack_segments``); ``halo_pack`` is the one-segment call.
"""
from __future__ import annotations

import ctypes
import math
from array import array
from typing import NamedTuple, Optional, Sequence

import torch

from . import _build

LAUNCHES = 0

# table capacities, as in csrc/halo_pack.cu (checked against the library)
MAX_SEGMENTS = 96
MAX_SOURCES = 32


class Segment(NamedTuple):
    """Rows ``idx`` of source ``src`` (rows of ``row`` elements) packed to
    ``dst[off : off + len(idx) * row]``."""
    src: int
    idx: torch.Tensor
    off: int
    row: int


class _Seg(ctypes.Structure):
    _fields_ = [("idx", ctypes.c_void_p), ("dst_off", ctypes.c_longlong),
                ("src", ctypes.c_int), ("cap", ctypes.c_int),
                ("row", ctypes.c_int), ("first", ctypes.c_int)]


class _Table(ctypes.Structure):
    _fields_ = [("nseg", ctypes.c_int), ("rows", ctypes.c_int),
                ("bf16", ctypes.c_int), ("nsrc", ctypes.c_int),
                ("dst", ctypes.c_void_p),
                ("srcs", ctypes.c_void_p * MAX_SOURCES),
                ("seg", _Seg * MAX_SEGMENTS)]


_SIGNATURES = {"halo_pack_segments": ([_build.P, _build.P], _build.I),
               "halo_pack_table_bytes": ([], _build.I)}
_FN = None


class PackPlan:
    """The host-static part of a segmented pack: index lists, source
    slots, destination offsets and row lengths.  Built once; each call
    supplies only the sources and the destination buffer.  ``launches``
    is what one kernel call makes: ``ceil(non-empty segments /
    MAX_SEGMENTS)``."""

    def __init__(self, segments: Sequence[Segment], bf16: bool = False):
        self.segments = tuple(segments)
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        self.numel = max((s.off + s.idx.shape[0] * s.row
                          for s in self.segments), default=0)
        self.n_sources = max((s.src + 1 for s in self.segments), default=0)
        if self.n_sources > MAX_SOURCES:
            raise ValueError(f"pack plan has {self.n_sources} sources, the "
                             f"kernel's table holds {MAX_SOURCES}")
        self._live = [s for s in self.segments
                      if s.idx.shape[0] and s.row]
        self.launches = math.ceil(len(self._live) / MAX_SEGMENTS)
        self._tables = None

    def tables(self):
        """The kernel's parameter tables (ctypes, built on first use) with
        their addresses: one per launch."""
        if self._tables is None:
            self._tables = []
            for lo in range(0, len(self._live), MAX_SEGMENTS):
                t = _Table()
                t.bf16 = int(self.dtype == torch.bfloat16)
                t.nsrc = self.n_sources
                first = 0
                for j, s in enumerate(self._live[lo:lo + MAX_SEGMENTS]):
                    if not (s.idx.dtype == torch.int32 and s.idx.dim() == 1
                            and s.idx.is_contiguous()):
                        raise ValueError("pack plan index lists must be "
                                         "contiguous 1-D int32")
                    cap = s.idx.shape[0]
                    t.seg[j] = _Seg(s.idx.data_ptr(), s.off, s.src, cap,
                                    s.row, first)
                    first += cap
                    t.nseg = j + 1
                t.rows = first
                self._tables.append((t, ctypes.addressof(t)))
        return self._tables


def _fn():
    global _FN
    if _FN is None:
        lib = _build.load("halo_pack", _SIGNATURES)
        if lib.halo_pack_table_bytes() != ctypes.sizeof(_Table):
            raise RuntimeError("halo_pack table layout differs between "
                               "csrc/halo_pack.cu and its wrapper")
        _FN = lib.halo_pack_segments
    return _FN


def pack_segments(plan: PackPlan, srcs: Sequence[torch.Tensor],
                  dst: torch.Tensor) -> torch.Tensor:
    """Pack every segment of ``plan`` into ``dst`` (a contiguous buffer of
    the plan's dtype and at least ``plan.numel`` elements) in
    ``plan.launches`` launches.  ``srcs``: contiguous float32 sources, in
    slot order.  CUDA tensors only.  The host side per call is the checks
    and one int64 array of this call's pointers; the table is static."""
    global LAUNCHES
    dev = dst.get_device()
    if dev < 0 or dst.dtype is not plan.dtype or not dst.is_contiguous() \
            or dst.numel() < plan.numel or len(srcs) < plan.n_sources:
        raise ValueError(f"halo_pack kernel takes a contiguous CUDA "
                         f"destination of {plan.dtype} [>= {plan.numel}] "
                         f"and >= {plan.n_sources} sources, got {dst.dtype} "
                         f"[{dst.numel()}] on {dst.device}, {len(srcs)}")
    live = array("q", (0, dst.data_ptr()))
    for s in srcs:
        if s.get_device() != dev or s.dtype is not torch.float32 or \
                not s.is_contiguous():
            raise ValueError("halo_pack kernel takes contiguous float32 "
                             "CUDA sources on the destination's device")
        live.append(s.data_ptr())
    if not plan.launches:                    # nothing to copy: never launch
        return dst
    fn = _fn()
    live[0] = _build.raw_stream(dst)
    addr = live.buffer_info()[0]
    for _, t_addr in plan.tables():
        err = fn(t_addr, addr)
        LAUNCHES += 1
        if err:
            _build.check(_build.load("halo_pack", _SIGNATURES), err,
                         "halo_pack")
    return dst


def halo_pack(x: torch.Tensor, idx: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-> packed ``[cap, *x.shape[1:]]``: one segment of the same kernel.

    x: ``[n, k, nv]`` float32 rows in node order; idx: ``[cap]`` int32
    planned send rows (padding entries may repeat row 0); out: optional
    contiguous float32 destination of the packed shape (for instance a
    view of a flat send buffer).  CUDA tensors only.
    """
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
    plan = PackPlan([Segment(0, idx, 0, math.prod(x.shape[1:]))])
    pack_segments(plan, [x], out.view(-1))
    return out
