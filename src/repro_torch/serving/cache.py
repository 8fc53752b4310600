"""Operator cache (DESIGN.md §9): amortize H^2 construction across requests
-- the port's copy of the reference's ``repro/serving/cache.py`` (plain
Python: the same LRU byte budget, single-flight builds and
``lookup_loosest``).

The paper's economics — an expensively-constructed H^2 operator amortizes
over many O(N) applies — only pay off in a service if construction happens
once per *operator identity*, not once per request.  Identity is the
``OperatorKey``: a digest of the point geometry, the kernel family and its
parameters, the construction/recompression tolerance, and the comm mode the
operator's plans were built for (a halo-plan operator and a single-device
one are different residents).

Cache-aside with single-flight fill: a miss runs the caller-supplied
build function *outside* the cache lock, and concurrent misses on the
same key wait on the first build instead of constructing the same
operator p times (thundering-herd protection).  Eviction is LRU under a
byte budget measured by the structure's own accounting
(``H2Shape.memory_lowrank`` + ``memory_dense``, scaled by dtype width) —
the same number the paper reports as compressed operator memory.

``OperatorKey.comm`` keys other than ``"local"`` name operators
partitioned for distributed serving: each rank's cache holds its shard,
served by a ``SolverService`` given the rank's ``comm`` in lockstep with
the other ranks (``serving/service.py``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


def geometry_digest(points: np.ndarray) -> str:
    """Stable digest of a point set (shape + dtype + raw bytes)."""
    pts = np.ascontiguousarray(points)
    h = hashlib.sha1()
    h.update(str(pts.shape).encode())
    h.update(str(pts.dtype).encode())
    h.update(pts.tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class OperatorKey:
    """Hashable cache identity of one constructed operator."""
    geometry: str                       # geometry_digest(points)
    kernel: Tuple[Any, ...]             # e.g. ("exponential", 0.1)
    tol: Optional[float]                # recompression tol (None = full rank)
    comm: str = "local"                 # "local" | "halo-plan" | "allgather"

    def loosened(self, tol: float) -> "OperatorKey":
        return dataclasses.replace(self, tol=tol)


@dataclasses.dataclass
class CacheEntry:
    """A resident operator: structure + arrays + per-panel-shape solver
    programs (``solvers`` is filled lazily by the service with the
    operator closures its solves run; their CUDA graphs live as long as
    those closures, so a cache hit reuses both the operator AND its
    captured programs)."""
    key: OperatorKey
    shape: Any                          # H2Shape
    data: Any                           # H2Data
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    solvers: Dict[Any, Any] = dataclasses.field(default_factory=dict)
    build_seconds: float = 0.0

    @property
    def nbytes(self) -> int:
        itemsize = 4                    # f32 value arrays
        return (self.shape.memory_lowrank() + self.shape.memory_dense()) \
            * itemsize


class OperatorCache:
    """LRU + byte-budget operator cache with single-flight construction.

    ``get_or_build(key, build_fn)`` returns the resident ``CacheEntry``;
    ``build_fn()`` must return ``(shape, data, extra)``.  Thread-safe;
    ``build_fn`` runs outside the lock and concurrent misses on the same
    key block on the winner's event.  A single entry larger than the whole
    budget is admitted anyway (the service cannot run without it) but
    evicts everything else.
    """

    def __init__(self, max_bytes: int = 1 << 30,
                 max_entries: Optional[int] = None):
        self.max_bytes = int(max_bytes)
        self.max_entries = max_entries
        self._entries: "OrderedDict[OperatorKey, CacheEntry]" = OrderedDict()
        self._building: Dict[OperatorKey, threading.Event] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.build_seconds = 0.0

    # -- introspection --------------------------------------------------
    @property
    def total_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: OperatorKey) -> bool:
        return key in self._entries

    def keys(self):
        return list(self._entries.keys())

    def stats(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "evictions": self.evictions, "entries": len(self._entries),
                "bytes": sum(e.nbytes for e in self._entries.values()),
                "build_seconds": self.build_seconds}

    # -- lookup ---------------------------------------------------------
    def peek(self, key: OperatorKey) -> Optional[CacheEntry]:
        """Non-faulting lookup (no LRU touch, no stats)."""
        return self._entries.get(key)

    def lookup_loosest(self, key: OperatorKey, max_tol: float
                       ) -> Optional[CacheEntry]:
        """Resident operator for the same (geometry, kernel, comm) with the
        loosest tolerance not exceeding ``max_tol`` — the degraded-mode
        candidate the circuit breaker falls back to (DESIGN.md §9)."""
        with self._lock:
            best = None
            for k, e in self._entries.items():
                if (k.geometry, k.kernel, k.comm) != \
                        (key.geometry, key.kernel, key.comm):
                    continue
                if k.tol is None or k.tol > max_tol or k == key:
                    continue
                if best is None or k.tol > best.key.tol:
                    best = e
            return best

    def get_or_build(self, key: OperatorKey,
                     build_fn: Callable[[], Tuple[Any, Any, Dict]]
                     ) -> CacheEntry:
        while True:
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    return entry
                evt = self._building.get(key)
                if evt is None:
                    # we are the single flight for this key
                    self._building[key] = threading.Event()
                    self.misses += 1
                    break
            evt.wait()                  # another thread is constructing
        try:
            t0 = time.perf_counter()
            shape, data, extra = build_fn()
            dt = time.perf_counter() - t0
            entry = CacheEntry(key=key, shape=shape, data=data,
                               extra=dict(extra or {}), build_seconds=dt)
            with self._lock:
                self.build_seconds += dt
                self._entries[key] = entry
                self._entries.move_to_end(key)
                self._evict_locked(keep=key)
            return entry
        finally:
            with self._lock:
                self._building.pop(key).set()

    def _evict_locked(self, keep: OperatorKey) -> None:
        def over():
            if self.max_entries is not None and \
                    len(self._entries) > self.max_entries:
                return True
            return sum(e.nbytes for e in self._entries.values()) \
                > self.max_bytes

        while over():
            victim = next((k for k in self._entries if k != keep), None)
            if victim is None:
                break                   # only `keep` left: admit oversize
            del self._entries[victim]
            self.evictions += 1
