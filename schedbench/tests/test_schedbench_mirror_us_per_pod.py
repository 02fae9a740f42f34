"""The arithmetic of mirror_us_per_pod.saturated, the reader of the
program's snapshot-mirror spans (`pod_events` and `mirror_rows`), on a
RunView built by hand as in test_schedbench_program_spans."""

from __future__ import annotations

import math

from schedbench.run import reader
from schedbench.tests.test_schedbench_program_spans import CYCLES, _view

# pods the window's cycles of CYCLES bound: 2,500 + 100 + 5,000
WINDOW_PODS = 7600


def test_schedbench_mirror_us_per_pod_finds_nothing_without_spans():
    read = reader("mirror_us_per_pod.saturated")
    assert read(_view(CYCLES, None)) is None
    assert read(_view(CYCLES, [("cycle", 10.0, 20.0), ("engine_step", 11.0, 12.0)])) is None


def test_schedbench_mirror_us_per_pod_takes_the_union_clipped_to_the_window():
    read = reader("mirror_us_per_pod.saturated")
    spans = [
        # a burst from before the window, overlapped by a row pass
        ("pod_events", 8.0, 11.0), ("mirror_rows", 10.5, 11.5),
        # a row pass inside a burst
        ("pod_events", 12.0, 13.0), ("mirror_rows", 12.5, 12.8),
        # a pass across the window's end, and a burst past it
        ("mirror_rows", 19.0, 21.0), ("pod_events", 25.0, 26.0),
        # other spans are not the mirror's
        ("cycle", 11.0, 19.0), ("mirror_emit", 12.4, 12.9),
    ]
    # (10, 11.5) + (12, 13) + (19, 20): 3.5 s over 7,600 pods
    got = read(_view(CYCLES, spans))
    assert math.isclose(got, 1e6 * 3.5 / WINDOW_PODS)
    assert read(_view(CYCLES, spans[:2])) == read(_view(CYCLES, spans[1::-1]))
    # no pod bound in the window
    assert read(_view(CYCLES[:1], spans)) is None


def test_schedbench_mirror_us_per_pod_reads_the_parents_bursts_whole():
    """A program without the row pass has `pod_events` alone: the reader
    takes the spans mirror_share takes, and keeps the bursts inside
    cycles (the self-apply of the binds) that mirror_share leaves out."""
    between = [("pod_events", 8.0, 11.0), ("pod_events", 12.0, 14.0), ("pod_events", 19.0, 22.0)]
    inside = [("pod_events", 18.0, 19.0), ("pod_events", 11.5, 12.0)]
    cycles = [("cycle", 11.0, 12.0), ("cycle", 14.0, 19.0)]
    view = _view(CYCLES, between + cycles + inside)
    share = reader("mirror_share.saturated")(view)
    per_pod = reader("mirror_us_per_pod.saturated")(view)
    # between cycles 1 + 2 + 1 s (mirror_share's 40% of 10 s), inside 1.5 s
    assert math.isclose(share, 40.0)
    assert math.isclose(per_pod * WINDOW_PODS / 1e6, share / 100.0 * 10.0 + 1.5)
    assert reader("mirror_us_per_pod.saturated")(_view(CYCLES, cycles)) is None
