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


def learned_from_reference(params) -> dict:
    """The port's NodeScorer state dict for a reference parameter tree
    (models/learned.py's flax params, as numpy arrays or anything
    np.asarray takes; with or without the top-level "params" key). Flax
    Dense kernels are [in, out], torch Linear weights [out, in]: each
    kernel is transposed, each bias kept. The names map one to one:
    params["pod_tower"]["Dense_0"]["kernel"] -> "pod_tower.Dense_0.weight".
    Tensors are float32 on the CPU (LearnedEngine moves them)."""
    import numpy as np
    import torch

    tree = params.get("params", params)
    out = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict) or hasattr(value, "items"):
                walk(value, path + (key,))
                continue
            a = np.asarray(value, np.float32)
            if key == "kernel":
                out[".".join(path + ("weight",))] = torch.from_numpy(np.array(a.T, order="C"))
            elif key == "bias":
                out[".".join(path + ("bias",))] = torch.from_numpy(a.copy())
            else:
                raise ValueError(f"unexpected leaf {'/'.join(path + (key,))}")

    walk(tree, ())
    return out
