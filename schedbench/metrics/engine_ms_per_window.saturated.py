"""engine_ms_per_window.saturated: Engine time per dispatched window, ms: the
sum of engine_seconds (dispatch to the result's read) over the window's
device cycles, over the windows they stacked."""

from schedbench.metrics._shared import engine_ms_per_window


def read(run):
    return engine_ms_per_window(run)
