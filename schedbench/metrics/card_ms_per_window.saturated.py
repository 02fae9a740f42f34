"""card_ms_per_window.saturated: the GPU-card path's device time per engine
window, ms: the program's CycleMetrics.card_seconds (CUDA events around
each card region of a window, the card policy's score and the card fit,
timed on cycles with spans on) summed over the window's device cycles,
over the engine windows they stacked. None when the program keeps no such
counter or timed nothing (a program without it, an untraced run, a
cluster without cards)."""

from schedbench.metrics._shared import device_cycles, windows


def read(run):
    cycles = device_cycles(run)
    secs = [getattr(c.metrics, "card_seconds", None) for c in cycles]
    if not cycles or None in secs or not sum(secs):
        return None
    w = windows(cycles, run.rec.batch_window)
    return 1e3 * sum(secs) / w if w else None
