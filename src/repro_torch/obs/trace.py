"""Phase annotation for profiles.

``phase("hgemv/upsweep")`` wraps a block in
``torch.profiler.record_function(name)``, which names the region in a
``torch.profiler`` trace (host range plus the device kernels launched under
it) and costs nothing measurable when no profiler is active.  Every phase
entered is recorded in ``PHASES_SEEN``, as in the reference.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Set

import torch

PHASES_SEEN: Set[str] = set()


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Annotate the enclosed work as belonging to ``name``."""
    PHASES_SEEN.add(name)
    with torch.profiler.record_function(name):
        yield
