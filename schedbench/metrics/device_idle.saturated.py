"""device_idle.saturated: Device idle share of the traced window, %: 1 - (union
of device operations' intervals) / window."""

from schedbench.metrics._shared import device_idle


def read(run):
    return device_idle(run)
