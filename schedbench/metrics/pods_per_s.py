"""pods_per_s: all pods bound by the window's whole cycles over the time
from the window's start to the end of its last cycle (closed backlog)."""


def read(run):
    cycles = run.rec.window()
    span = run.rec.window_t1 - run.rec.window_t0
    if not cycles or span <= 0:
        return None
    return sum(c.metrics.pods_bound for c in cycles) / span
