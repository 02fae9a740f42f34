"""card_roofline.saturated: the GPU-card path's share of its roofline, %:
the least time of each engine window's card work (schedbench/card_cost.py
from the window's pods, the configuration's nodes and its cards a node;
schedbench/roofline.least_s) summed over the window's device cycles, over
the device seconds the program timed there (CycleMetrics.card_seconds, as
card_ms_per_window.saturated). None when the program timed nothing or the
configuration has no cards."""

import math

from schedbench.card_cost import card_cost, window_pods
from schedbench.metrics._shared import device_cycles
from schedbench.roofline import least_s


def read(run):
    cycles = device_cycles(run)
    secs = [getattr(c.metrics, "card_seconds", None) for c in cycles]
    cards = run.rec.config["node"].get("cards")
    if not cycles or None in secs or not sum(secs) or not cards:
        return None
    n, c = int(run.rec.config["nodes"]), int(cards["per_node"])
    least = math.fsum(least_s(*card_cost(p, n, c)) for cyc in cycles
                      for p in window_pods(cyc.metrics.pods_in, run.rec.batch_window))
    return 100.0 * least / sum(secs)
