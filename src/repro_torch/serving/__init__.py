"""Fault-tolerant H^2 solver service (DESIGN.md §9), the port of the
reference's ``repro.serving``: operator cache with LRU + byte-budget
eviction and single-flight fill, bounded-queue admission with
backpressure, continuous multi-RHS batching over segmented ``block_cg``,
and a fault layer (deterministic injection, retry with backoff + jitter,
straggler hedging, circuit breaker with degraded modes) built on
``repro_torch.runtime.fault``."""
from repro_torch.serving.batching import (Completion, PanelState, QueueFull,
                                          RequestQueue, SolveRequest)
from repro_torch.serving.cache import (CacheEntry, OperatorCache,
                                       OperatorKey, geometry_digest)
from repro_torch.serving.loadgen import PoissonLoad
from repro_torch.serving.service import (ServeReport, ServiceFaultPlan,
                                         SolverService,
                                         ThreadedSolverService,
                                         default_make_apply,
                                         default_make_dist_apply,
                                         gather_answers)

__all__ = [
    "OperatorCache", "OperatorKey", "CacheEntry", "geometry_digest",
    "RequestQueue", "QueueFull", "SolveRequest", "Completion", "PanelState",
    "PoissonLoad", "SolverService", "ThreadedSolverService",
    "ServiceFaultPlan", "ServeReport",
    "default_make_apply", "default_make_dist_apply", "gather_answers",
]
