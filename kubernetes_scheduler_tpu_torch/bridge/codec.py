"""Tensor (de)serialization for the host <-> sidecar bridge.

Packs the engine's NamedTuples (SnapshotArrays / PodBatch /
ScheduleResult) into `NamedTensors` protobuf maps of raw C-order bytes —
the accelerator-era analog of the reference shipping per-node scalars
through Redis keys (pkg/yoda/score/algorithm.go:74-88): one dense
transfer per cycle instead of O(N) round-trips.

The port's copy of kubernetes_scheduler_tpu/bridge/codec.py. Packing
takes host arrays (numpy, or CPU tensors): a CUDA tensor raises, and a
result on the card is read through device.to_host first, one read per
reply.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_scheduler_tpu_torch.bridge import schedule_pb2 as pb

_ALLOWED_DTYPES = {"float32", "float64", "int32", "int64", "bool", "uint8"}


def _host(a):
    """`a` as a host array; a tensor off the CPU raises (no quiet read)."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise TypeError(
                f"bridge tensors are host arrays: read the {a.device} tensor "
                "through device.to_host first"
            )
        return a.detach().numpy()
    return np.asarray(a)


def pack_array(a) -> pb.Tensor:
    arr = _host(a)
    shape = arr.shape  # before ascontiguousarray, which promotes 0-d to 1-d
    arr = np.ascontiguousarray(arr)
    name = "bool" if arr.dtype == np.bool_ else arr.dtype.name
    if name not in _ALLOWED_DTYPES:
        raise TypeError(f"unsupported dtype {arr.dtype} for bridge tensor")
    return pb.Tensor(dtype=name, shape=list(shape), data=arr.tobytes())


def unpack_array(t: pb.Tensor) -> np.ndarray:
    if t.dtype not in _ALLOWED_DTYPES:
        raise TypeError(f"unsupported dtype {t.dtype!r} on the wire")
    dtype = np.bool_ if t.dtype == "bool" else np.dtype(t.dtype)
    arr = np.frombuffer(t.data, dtype=dtype)
    shape = tuple(t.shape)
    expect = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if arr.size != expect:
        raise ValueError(
            f"tensor payload has {arr.size} elements, shape {shape} needs {expect}"
        )
    return arr.reshape(shape)


def pack_fields(
    nt, out: pb.NamedTensors, *, only=None, cache: dict | None = None
) -> pb.NamedTensors:
    """Pack a NamedTuple of arrays field-by-field into a NamedTensors map.

    With `cache` (the client side of the wire field cache — a plain
    {field: ndarray} of this session's previously sent values), a leaf
    bytewise-identical to its predecessor is replaced by a
    `same_as_last` marker instead of its payload — most snapshot leaves
    (allocatable, labels, taints, masks, utilization series) are
    identical cycle after cycle. The caller owns the protocol
    preconditions: the sidecar advertised HealthReply.field_cache and
    the request carries the session_id the cache is scoped to."""
    for name, value in zip(type(nt)._fields, nt):
        if only is not None and name not in only:
            continue
        if cache is not None:
            arr = np.ascontiguousarray(_host(value))
            prev = cache.get(name)
            if (
                prev is not None
                and prev.dtype == arr.dtype
                and prev.shape == arr.shape
                and np.array_equal(prev, arr)
            ):
                out.tensors[name].same_as_last = True
                continue
            # own copy: the comparison must never read a buffer the
            # caller mutates after the send
            cache[name] = arr.copy()
        out.tensors[name].CopyFrom(pack_array(value))
    return out


class FieldCacheMiss(KeyError):
    """A same_as_last tensor referenced a field this server has no
    cached value for (sidecar restart, evicted session, skewed client)."""


def unpack_fields(
    cls,
    named: pb.NamedTensors,
    *,
    defaults: dict | None = None,
    cache: dict | None = None,
):
    """Rebuild NamedTuple `cls` from a NamedTensors map.

    Missing fields fall back to `defaults` (used for decisions_only
    replies, and for struct leaves newer than the sending client — e.g.
    the gang tensors an old host never ships); a CALLABLE default is
    invoked with the kwargs decoded so far, so it can shape itself from
    earlier fields. Unknown wire fields are rejected so schema drift
    fails loud.

    With `cache` (the server side of the wire field cache), a
    `same_as_last` tensor resolves to the session's previously received
    value — raising FieldCacheMiss when there is none (the handler
    aborts FAILED_PRECONDITION "field-cache-miss" and the client resends
    in full) — and every full tensor refreshes its cache slot.
    """
    fields = cls._fields
    unknown = set(named.tensors) - set(fields)
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields on the wire: {sorted(unknown)}")
    kwargs = {}
    for name in fields:
        if name in named.tensors:
            t = named.tensors[name]
            if t.same_as_last:
                if cache is None or name not in cache:
                    raise FieldCacheMiss(
                        f"field-cache-miss: {cls.__name__}.{name}"
                    )
                kwargs[name] = cache[name]
            else:
                arr = unpack_array(t)
                if cache is not None:
                    cache[name] = arr
                kwargs[name] = arr
        elif defaults is not None and name in defaults:
            d = defaults[name]
            kwargs[name] = d(kwargs) if callable(d) else d
        else:
            raise ValueError(f"missing {cls.__name__} field {name!r} on the wire")
    return cls(**kwargs)
