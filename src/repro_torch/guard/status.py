"""Solver status codes: names and host-side helpers.

The codes themselves are defined in ``repro_torch.solvers.krylov`` (they
ride the solvers' device-side carries, so the solver module must not import
the guard package) and re-exported here as the guard-facing vocabulary.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.solvers.krylov import (STATUS_BREAKDOWN, STATUS_INDEFINITE,
                                        STATUS_NAN, STATUS_OK,
                                        STATUS_STAGNATION, guards_enabled,
                                        set_guards_enabled)

STATUS_NAMES = {
    STATUS_OK: "ok",
    STATUS_NAN: "nan",
    STATUS_INDEFINITE: "indefinite",
    STATUS_STAGNATION: "stagnation",
    STATUS_BREAKDOWN: "breakdown",
}


def worst_status(status) -> int:
    """Collapse a scalar or per-column status (int, tensor or array) to one
    host int: 0 iff every entry is OK, else the largest (most specific)
    trip code."""
    if status is None:
        return STATUS_OK
    return int(torch.as_tensor(status).max())


def status_name(status: Union[int, torch.Tensor, None]) -> str:
    """Human name of a (possibly per-column) status code."""
    return STATUS_NAMES.get(worst_status(status), "unknown")


__all__ = ["STATUS_OK", "STATUS_NAN", "STATUS_INDEFINITE",
           "STATUS_STAGNATION", "STATUS_BREAKDOWN", "STATUS_NAMES",
           "status_name", "worst_status", "guards_enabled",
           "set_guards_enabled"]
