"""sys layer — init/options/tracing/debug (reference: src/sys, permonsys.h)."""

from .options import Options, solve_from_options, tolerances_from_options
from .tracing import (
    debug,
    event_report,
    info,
    log_event,
    set_from_options,
    trace,
    traced,
)
