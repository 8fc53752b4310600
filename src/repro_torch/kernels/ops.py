"""Backend dispatch over the hand-written kernels.

``backend="cuda"`` (the default) launches the CUDA kernel on a CUDA tensor
-- a failed build or launch raises, nothing falls back -- and takes the
plain version in ``ref.py`` only for a tensor that lies on the CPU.
``backend="torch"`` is the plain PyTorch path on any device (the
counterpart of the reference's ``"jnp"``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from . import batched_gemm as _bg
from . import batched_qr as _bq
from . import batched_svd as _bs
from . import coupling_mv as _cm
from . import halo_pack as _hp
from . import ref

BACKENDS = ("cuda", "torch")
_KERNEL_MODULES = {"batched_gemm": _bg, "coupling_mv": _cm,
                   "batched_qr": _bq, "batched_svd": _bs, "halo_pack": _hp}


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return {name: mod.LAUNCHES for name, mod in _KERNEL_MODULES.items()}


def route_launch_counts() -> Dict[str, Dict[str, int]]:
    """Launches of each route of the kernels that have several (their
    planners choose), since the last ``reset_launch_counts``."""
    return {name: dict(mod.ROUTE_LAUNCHES)
            for name, mod in _KERNEL_MODULES.items()
            if hasattr(mod, "ROUTE_LAUNCHES")}


def reset_launch_counts() -> None:
    for mod in _KERNEL_MODULES.values():
        mod.LAUNCHES = 0
        for route in getattr(mod, "ROUTE_LAUNCHES", {}):
            mod.ROUTE_LAUNCHES[route] = 0


def use_kernel(t: torch.Tensor, backend: str) -> bool:
    """True when ``backend`` asks for the kernel and ``t`` is on the card."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    return backend == "cuda" and t.is_cuda


def batched_gemm(a: torch.Tensor, b: torch.Tensor,
                 backend: str = "cuda") -> torch.Tensor:
    if use_kernel(a, backend):
        return _bg.batched_gemm(a, b)
    if 0 in a.shape or 0 in b.shape:
        return a.new_zeros((a.shape[0], a.shape[1], b.shape[2]))
    return ref.batched_gemm(a, b)


def coupling_mv(s: torch.Tensor, x: torch.Tensor, blk: torch.Tensor,
                col: torch.Tensor, cnt: torch.Tensor, *, maxb: int,
                backend: str = "cuda") -> torch.Tensor:
    if use_kernel(s, backend):
        return _cm.coupling_mv(s, x, blk, col, cnt, maxb=maxb)
    return ref.coupling_mv(s, x, blk, col, cnt, maxb=maxb)


def backend_qr(a: torch.Tensor, backend: str = "cuda"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduced QR, sign-fixed (the helper orthogonalize shares)."""
    if use_kernel(a, backend):
        return _bq.batched_qr(a)
    nb, n, k = a.shape
    if 0 in a.shape:
        kn = min(n, k)
        return a.new_zeros((nb, n, kn)), a.new_zeros((nb, kn, k))
    return ref.batched_qr(a)


def backend_qr_r(a: torch.Tensor, backend: str = "cuda") -> torch.Tensor:
    """R factor only (the compression weights)."""
    if use_kernel(a, backend):
        return _bq.batched_qr_r(a)
    return backend_qr(a, backend)[1]


def backend_svd(a: torch.Tensor, backend: str = "cuda", want_vt: bool = True,
                polish: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
    """Reduced SVD.  ``want_vt=False`` lets the kernel skip V^T (it then
    returns None there) and ``polish=False`` the QR polish of U (for a
    caller that reads sigma alone); the plain path computes it all the
    same."""
    if use_kernel(a, backend):
        return _bs.batched_svd(a, want_vt=want_vt, polish=polish)
    nb, n, k = a.shape
    if 0 in a.shape:
        kn = min(n, k)
        return (a.new_zeros((nb, n, kn)), a.new_zeros((nb, kn)),
                a.new_zeros((nb, kn, k)))
    return ref.batched_svd(a)


def halo_pack(x: torch.Tensor, idx: torch.Tensor, backend: str = "cuda",
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pack the planned send rows ``x[idx]`` (into ``out`` when given)."""
    if use_kernel(x, backend):
        return _hp.halo_pack(x, idx, out=out)
    y = ref.halo_pack(x, idx)
    return y if out is None else out.copy_(y)


def halo_pack_segments(plan: "_hp.PackPlan", srcs: Sequence[torch.Tensor],
                       dst: torch.Tensor, backend: str = "cuda"
                       ) -> torch.Tensor:
    """Pack every segment of ``plan`` into the flat buffer ``dst``: one
    kernel launch (per ``MAX_SEGMENTS`` segments) on the card, a loop of
    ``index_select`` otherwise."""
    if use_kernel(dst, backend):
        return _hp.pack_segments(plan, srcs, dst)
    return ref.halo_pack_segments(plan.segments, srcs, dst)
