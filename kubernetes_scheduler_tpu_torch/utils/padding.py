"""Bucketed padding (counterpart of kubernetes_scheduler_tpu/utils/padding.py):
the host rounds the node and pod axes up to power-of-two buckets
(`bucket_size`), so device buffers and kernel shapes repeat from cycle to
cycle, and a backlog is padded with pod_mask=False rows to a multiple of
the window before stack_windows. Works on numpy arrays and torch tensors
alike."""

from __future__ import annotations

import numpy as np
import torch


def bucket_size(n: int, *, floor: int = 8, multiple: int = 8) -> int:
    """Smallest power-of-two bucket >= n, at least `floor`, a multiple of
    `multiple`."""
    b = floor
    while b < n:
        b *= 2
    return int(np.ceil(b / multiple) * multiple)


def pad_axis(arr, size: int, axis: int = 0, fill=0):
    """Pad `axis` of `arr` (numpy or tensor) with `fill` up to `size`."""
    cur = arr.shape[axis]
    if cur == size:
        return arr
    if cur > size:
        raise ValueError(f"axis {axis} has {cur} > bucket {size}")
    if isinstance(arr, torch.Tensor):
        shape = list(arr.shape)
        shape[axis] = size - cur
        return torch.cat([arr, arr.new_full(shape, fill)], dim=axis)
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, size - cur)
    return np.pad(arr, widths, constant_values=fill)


def pad_to_bucket(arr: np.ndarray, axis: int = 0, *, floor: int = 8, fill=0):
    """Pad `axis` of a host array up to its bucket; returns (padded, mask)
    where mask is a bool array over the padded axis marking real entries."""
    size = bucket_size(arr.shape[axis], floor=floor)
    mask = np.zeros(size, bool)
    mask[: arr.shape[axis]] = True
    return pad_axis(arr, size, axis, fill), mask


# fields whose "absent" encoding is -1, not 0 (make_pod_batch defaults):
# selector ids, the nodeName pin, the card wants and the gang slot
_NEG_SENTINEL_FIELDS = frozenset({
    "affinity_sel", "anti_affinity_sel", "spread_sel", "target_node",
    "pref_affinity_sel", "pref_anti_sel", "want_memory", "want_clock",
    "gang_id",
})


def pad_pod_batch(pods, size: int):
    """Pad every leaf of a PodBatch along the pod axis to `size`, with
    pod_mask False on the padding and each field's absent sentinel (-1
    for selector/pin/card-want/gang fields, 0 elsewhere)."""
    p = pods.request.shape[0]
    if p > size:
        raise ValueError(f"pod count {p} > target {size}")
    if p == size:
        return pods
    return type(pods)(
        *[
            pad_axis(
                f if isinstance(f, torch.Tensor) else np.asarray(f), size, 0,
                fill=-1 if name in _NEG_SENTINEL_FIELDS else 0,
            )
            for name, f in zip(pods._fields, pods)
        ]
    )
