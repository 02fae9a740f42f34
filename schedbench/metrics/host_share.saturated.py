"""host_share.saturated: Share of the host loop in the cycles' time, %: (sum of
cycle_seconds - sum of engine_seconds) / sum of cycle_seconds, from the
program's CycleMetrics over the window."""

from schedbench.metrics._shared import host_share


def read(run):
    return host_share(run)
