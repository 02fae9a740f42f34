"""informer_share.saturated: share of the window's wall time, %, that the
informer's pod DELETED events take in the program's snapshot mirror
(host/mirror.SnapshotMirror.apply_pod_event), timed by the host clock
around the harness's deletions between cycles."""

from schedbench.metrics._shared import stage_share


def read(run):
    return stage_share(run, "schedbench.delete")
