"""k1_roofline.saturated: K1 masked_score's share of its roofline, %: the
launches' least times, counted by schedbench/roofline.py from each launch's
shapes, over K1's device time."""

from schedbench.metrics._shared import k1_roofline


def read(run):
    return k1_roofline(run)
