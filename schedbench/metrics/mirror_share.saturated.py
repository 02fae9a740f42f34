"""mirror_share.saturated: share of the window's wall time, %, that the
informer's pod events take in the program's snapshot mirror, timed by the
program: its `pod_events` spans (the bursts of events that
host/mirror.SnapshotMirror.apply_pod_event times), clipped to the window,
less the time they overlap the program's `cycle` spans. That is
informer_share.saturated's definition (the events between cycles), timed
by the program instead of by the harness. The bursts inside a cycle, the
mirror's self-apply of the cycle's binds, are the host loop's. None when
the run recorded no `pod_events` span."""


def read(run):
    if run.trace is None:
        return None
    rec = run.rec
    span = rec.window_t1 - rec.window_t0
    bursts = [(t0, t1) for name, t0, t1 in run.trace.spans if name == "pod_events"]
    if span <= 0 or not bursts:
        return None
    cycles = [(t0, t1) for name, t0, t1 in run.trace.spans if name == "cycle"]
    total = 0.0
    for t0, t1 in bursts:
        a, b = max(t0, rec.window_t0), min(t1, rec.window_t1)
        if b <= a:
            continue
        # cycles never overlap one another
        total += (b - a) - sum(max(0.0, min(b, c1) - max(a, c0)) for c0, c1 in cycles)
    return 100.0 * total / span
