"""Guard rails of the port (``repro.guard``); so far the solver status
vocabulary (``status``)."""
from .status import (STATUS_BREAKDOWN, STATUS_INDEFINITE, STATUS_NAMES,
                     STATUS_NAN, STATUS_OK, STATUS_STAGNATION,
                     guards_enabled, set_guards_enabled, status_name,
                     worst_status)

__all__ = ["STATUS_OK", "STATUS_NAN", "STATUS_INDEFINITE",
           "STATUS_STAGNATION", "STATUS_BREAKDOWN", "STATUS_NAMES",
           "status_name", "worst_status", "guards_enabled",
           "set_guards_enabled"]
