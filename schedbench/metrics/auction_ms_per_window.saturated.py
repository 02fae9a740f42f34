"""auction_ms_per_window.saturated: the auction's time per engine window,
ms: the program's `auction` spans (ops/assign.auction_assign, whole) of
the traced window, over the engine windows its device cycles stacked.
None when the run recorded no such span."""

from schedbench.metrics._shared import device_cycles, windows


def read(run):
    if run.trace is None:
        return None
    secs = [t1 - t0 for name, t0, t1 in run.trace.spans if name == "auction"]
    w = windows(device_cycles(run), run.rec.batch_window)
    return 1e3 * sum(secs) / w if secs and w else None
