"""mirror_us_per_pod.saturated: microseconds of the program's snapshot
mirror per pod bound, timed by the program: the union of its
`pod_events` spans (the bursts of events that
host/mirror.SnapshotMirror.apply_pod_event and apply_pod_events time:
the informer's deletions and the self-apply of each cycle's binds) and
its `mirror_rows` spans (the row pass over the nodes those events
marked, inside `mirror_emit`), clipped to the window, over the pods the
window's cycles bound. A program without the row pass has `pod_events`
alone, which then hold all of its event work. None when the run
recorded neither span or bound no pod."""

NAMES = ("pod_events", "mirror_rows")


def read(run):
    if run.trace is None:
        return None
    rec = run.rec
    w0, w1 = rec.window_t0, rec.window_t1
    pods = sum(c.metrics.pods_bound for c in rec.window())
    spans = sorted(
        (max(t0, w0), min(t1, w1))
        for name, t0, t1 in run.trace.spans if name in NAMES
    )
    if not spans or pods <= 0:
        return None
    total, end = 0.0, w0
    for a, b in spans:
        a = max(a, end)
        if b > a:
            total += b - a
            end = b
    return 1e6 * total / pods
