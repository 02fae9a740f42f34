"""Carry cluster state and pod windows across from the reference.

A scheduler has no weights: its parameters are the cluster snapshot and
the pending-pod window. `from_reference` turns any NamedTuple with the
field names of the reference's SnapshotArrays or PodBatch (JAX arrays,
numpy arrays, or tensors as leaves) into the port's type on a device,
with the dtypes make_snapshot / make_pod_batch fix.
"""

from __future__ import annotations

from kubernetes_scheduler_tpu_torch.engine import (
    PodBatch,
    SnapshotArrays,
    make_pod_batch,
    make_snapshot,
)


def from_reference(nt, device=None):
    """The port's SnapshotArrays or PodBatch for `nt`, on `device`
    (default cuda). Every leaf passes through np.asarray (tensors are
    moved directly); a windows PodBatch keeps its leading window axis."""
    fields = getattr(nt, "_fields", None)
    if fields == SnapshotArrays._fields:
        return make_snapshot(**nt._asdict(), device=device)
    if fields == PodBatch._fields:
        return make_pod_batch(**nt._asdict(), device=device)
    raise TypeError(
        f"from_reference expects a SnapshotArrays or PodBatch NamedTuple, "
        f"not {type(nt).__name__}"
    )
