"""Exact rows of kernel matrices, in float64 and in blocks of rows (never
the whole matrix)."""
from __future__ import annotations

from typing import Callable

import torch


def kernel_rows(pts: torch.Tensor, kernel: Callable, rows: torch.Tensor,
                x: torch.Tensor, chunk: int = 32) -> torch.Tensor:
    """``(K x)[rows]`` with ``K[i, j] = kernel(p_i, p_j)``; ``pts`` [N,
    dim] float64, ``x`` [N, nv] (any float type, taken as float64)."""
    xd = x.double()
    out = [kernel(pts[rows[a:a + chunk]][:, None, :], pts[None, :, :]) @ xd
           for a in range(0, rows.shape[0], chunk)]
    return torch.cat(out)


def kernel_rows_low(pts: torch.Tensor, kernel: Callable, rows: torch.Tensor,
                    x: torch.Tensor, chunk: int = 32) -> torch.Tensor:
    """``kernel_rows`` one precision down, the control of a float32
    product: the kernel's rows rounded to float32 and multiplied in TF32
    (float32 with TF32 off is the port's precision)."""
    x32 = x.float()
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = [kernel(pts[rows[a:a + chunk]][:, None, :],
                      pts[None, :, :]).float() @ x32
               for a in range(0, rows.shape[0], chunk)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return torch.cat(out).double()
