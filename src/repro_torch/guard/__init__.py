"""Numerical guard rails of the port (``repro.guard``, DESIGN.md §11).

- operator certification: ``validate`` (structural invariants) and
  ``certify`` (a stochastic a-posteriori error estimate against a
  reference apply);
- solver breakdown guards: ``status`` (the status codes the Krylov
  segments carry);
- escalation: ``escalate`` (``run_with_guards`` ladders, counted in
  ``GUARD_COUNTERS``; the certified sketch construction);
- ``drills``: deterministic numerical faults.
"""
from .status import (STATUS_BREAKDOWN, STATUS_INDEFINITE, STATUS_NAMES,
                     STATUS_NAN, STATUS_OK, STATUS_STAGNATION,
                     guards_enabled, set_guards_enabled, status_name,
                     worst_status)
from .validate import (ValidationReport, check_orthogonal, validate_dist_h2,
                       validate_h2)
from .certify import (CERT_STREAM, Certificate, certify_h2, certify_matvec,
                      kernel_reference_apply, probe_block)
from .escalate import (GUARD_COUNTERS, GuardOutcome, construct_h2_certified,
                       default_accept, fp64_scalars, reset_guard_counters,
                       run_with_guards)
from .drills import (drill_corrupt_operator, drill_near_singular,
                     drill_rank_starved)

__all__ = [
    "STATUS_OK", "STATUS_NAN", "STATUS_INDEFINITE", "STATUS_STAGNATION",
    "STATUS_BREAKDOWN", "STATUS_NAMES", "status_name", "worst_status",
    "guards_enabled", "set_guards_enabled",
    "ValidationReport", "validate_h2", "validate_dist_h2",
    "check_orthogonal",
    "Certificate", "certify_matvec", "certify_h2",
    "kernel_reference_apply", "probe_block", "CERT_STREAM",
    "GUARD_COUNTERS", "GuardOutcome", "run_with_guards", "default_accept",
    "fp64_scalars", "construct_h2_certified", "reset_guard_counters",
    "drill_corrupt_operator", "drill_rank_starved", "drill_near_singular",
]
