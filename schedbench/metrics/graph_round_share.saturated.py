"""graph_round_share.saturated: the share of the auction's rounds that the
program ran by replaying a captured block of rounds (a CUDA graph that an
earlier engine call captured), %: 100 x CycleMetrics.auction_graph_rounds
over CycleMetrics.auction_rounds, each summed over the window's device
cycles. None when the program keeps no such field or counted no round."""

from schedbench.metrics._shared import device_cycles


def read(run):
    cycles = device_cycles(run)
    graphed = [getattr(c.metrics, "auction_graph_rounds", None) for c in cycles]
    if not cycles or None in graphed:
        return None
    rounds = sum(getattr(c.metrics, "auction_rounds", 0) for c in cycles)
    return 100.0 * sum(graphed) / rounds if rounds else None
