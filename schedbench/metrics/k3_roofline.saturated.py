"""k3_roofline.saturated: K3 auction_bid's share of its roofline, %, as
k1_roofline.saturated."""

from schedbench.metrics._shared import k3_roofline


def read(run):
    return k3_roofline(run)
