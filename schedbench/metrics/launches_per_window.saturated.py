"""launches_per_window.saturated: Device kernels torch.profiler saw per engine
window, over the traced window's whole cycles."""

from schedbench.metrics._shared import launches_per_window


def read(run):
    return launches_per_window(run)
