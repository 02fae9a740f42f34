"""The frozen roofline count at a known shape, and the trace's union."""

from __future__ import annotations

import math

from schedbench import roofline
from schedbench.profile import DeviceTrace


def test_schedbench_k1_cost_at_a_known_shape():
    p, n, r = 1024, 10_000, 3
    nbytes, ops = roofline.k1_cost(p, n, r, 0, False, True)
    assert nbytes == p * 13 + n * 9 + 4 * (p * r + 2 * n * r) + 8 * p + 4 * p * n
    assert ops == p * n * (6 + 2 * r + 3)
    # bytes bound: the [p, n] float32 write dominates
    assert math.isclose(roofline.least_s(nbytes, ops), nbytes / 3.35e12)
    assert 12.3e-6 < roofline.least_s(nbytes, ops) < 12.4e-6


def test_schedbench_k3_cost_counts_active_rows_only():
    full = roofline.k3_cost(1024, 5000, 3, 1024)[0]
    few = roofline.k3_cost(1024, 5000, 3, 10)[0]
    assert full - few == 4 * (1024 - 10) * 5000


def test_schedbench_busy_time_is_the_union_of_intervals():
    ops = [("a", 0.0, 1.0), ("b", 0.5, 1.0), ("c", 3.0, 1.0), ("d", 9.5, 2.0)]
    spans = [("cycle", 0.0, 10.0), ("bind", 1.5, 2.5)]
    tr = DeviceTrace(ops=ops, window=(0.0, 10.0), spans=spans)
    assert math.isclose(tr.busy_s(), 1.5 + 1.0 + 0.5)
    gaps = tr.idle_gaps()
    assert math.isclose(gaps["bind"], 1.5)
    assert math.isclose(gaps["cycle"], 5.5)
    assert tr.by_name(("a",)) == {"a": 1.0}
