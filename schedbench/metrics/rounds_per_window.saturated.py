"""rounds_per_window.saturated: the auction's rounds per engine window:
the program's round counter (CycleMetrics.auction_rounds) summed over the
window's device cycles, over the engine windows they stacked. None when
the program keeps no such counter or counted no round."""

from schedbench.metrics._shared import device_cycles, windows


def read(run):
    cycles = device_cycles(run)
    rounds = [getattr(c.metrics, "auction_rounds", None) for c in cycles]
    if not cycles or None in rounds:
        return None
    w = windows(cycles, run.rec.batch_window)
    return sum(rounds) / w if w and sum(rounds) else None
