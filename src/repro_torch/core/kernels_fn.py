"""Kernel functions for the paper's test sets, on torch tensors.

- 2D/3D exponential kernels (spatial statistics / Gaussian process, §6.1)
- fractional-diffusion kernel with variable diffusivity (§6.4)

Each factory returns ``k(x, y)`` over broadcastable ``[..., dim]`` tensors.
The construction evaluates them in float64 on the device.
"""
from __future__ import annotations

from typing import Callable

import torch


def exponential_kernel(correlation_length: float) -> Callable:
    """exp(-|x-y| / l) — the paper's covariance kernels (§6.1)."""
    def k(x, y):
        r = torch.linalg.norm(x - y, dim=-1)
        return torch.exp(-r / correlation_length)
    return k


def bump(x: torch.Tensor, c: float, ell: float) -> torch.Tensor:
    """Paper Eq. (7)."""
    r = (x - c) / (ell / 2.0)
    inside = r.abs() < 1.0
    rsafe = torch.where(inside, r, torch.zeros_like(r))
    return torch.where(inside, torch.exp(-1.0 / (1.0 - rsafe ** 2)),
                       torch.zeros_like(x))


def diffusivity_2d(x: torch.Tensor) -> torch.Tensor:
    """kappa(x) = 1 + f(x1; 0, 1.5) f(x2; 0, 2.0) — paper Eq. (6)."""
    return 1.0 + bump(x[..., 0], 0.0, 1.5) * bump(x[..., 1], 0.0, 2.0)


def fractional_kernel_2d(beta: float) -> Callable:
    """K(x,y) = -2 a(x,y) / |y-x|^(2+2*beta), a = sqrt(kappa(x) kappa(y)).

    Paper Eq. (11); the singular diagonal is zeroed.
    """
    def k(x, y):
        r = torch.linalg.norm(x - y, dim=-1)
        a = torch.sqrt(diffusivity_2d(x) * diffusivity_2d(y))
        tiny = 1e-300 if r.dtype == torch.float64 else 1e-30
        v = -2.0 * a / torch.clamp(r, min=tiny) ** (2.0 + 2.0 * beta)
        return torch.where(r == 0.0, torch.zeros_like(r), v)
    return k


def fractional_kernel_2d_positive(beta: float) -> Callable:
    """+2a/|y-x|^(2+2b): used for the diagonal D = Khat @ 1 (Eq. 10)."""
    neg = fractional_kernel_2d(beta)

    def k(x, y):
        return -neg(x, y)
    return k
