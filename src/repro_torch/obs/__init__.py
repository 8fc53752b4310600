"""Observability for the PyTorch port (the reference's ``repro/obs``).

``obs.trace`` annotates the hot paths with neutral phase ranges and keeps
each phase's count and host seconds (``span_totals``);
``obs.timers`` measures them (segmented replay, interleaved rounds);
``obs.metrics`` joins measured time with modeled flops and comm bytes;
``obs.export`` writes Chrome-trace timelines; ``obs.profile_solve`` is the
CLI that runs the whole pipeline on the distributed fractional solve.

Only ``trace`` is imported eagerly: it is on the hot path of ``core`` and
``solvers`` and must stay import-light.
"""
from repro_torch.obs.trace import (PHASES_SEEN, annotate, enabled, phase,
                                   reset_span_totals, set_enabled,
                                   span_totals)

__all__ = ["phase", "annotate", "enabled", "set_enabled", "PHASES_SEEN",
           "span_totals", "reset_span_totals",
           "timers", "metrics", "export", "profile_solve"]


def __getattr__(name):
    if name in ("timers", "metrics", "export", "profile_solve"):
        import importlib
        return importlib.import_module(f"repro_torch.obs.{name}")
    raise AttributeError(f"module 'repro_torch.obs' has no attribute "
                         f"{name!r}")
