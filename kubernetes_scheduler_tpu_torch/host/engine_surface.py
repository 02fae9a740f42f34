"""The engine surface: every call the host loop, the fleet pool, the
replayer, the shadow and the sidecar make on an engine, stated once.

TorchEngine, ShardedEngine, LearnedEngine, RemoteEngine and the shared
pool's per-replica view subclass `EngineSurface`. What an engine does
not serve is an answer here, never a missing attribute: the resident,
windows-resident and fleet calls are guarded by `supports_resident()`,
`supports_windows_resident()` and `supports_fleet()`, which answer
False; `preempt` answers None (the host then runs the pass in-host);
the telemetry hooks do nothing. A subclass overrides what it computes
differently.

This module imports no torch, so the pool and the fault wrapper stay
importable where torch is not.
"""

from __future__ import annotations


class EngineSurface:
    # the device the engine launches on; None for an engine with no
    # single device of its own (a sidecar client, a pool view)
    device = None
    # node shards of a mesh-sharded engine; 0 off the mesh
    n_shards = 0
    # the last delta cycle's routed payload per shard (mesh engines)
    shard_delta_bytes: tuple = ()
    # did the last resident call fold a delta (True) or upload in full?
    resident_used_delta = False
    # a circuit breaker the engine gates its own calls with (a sidecar
    # client's); None lets the host own the engine's breaker
    breaker = None
    # metric collectors the host exporter serves beside its own
    collectors: tuple = ()

    # ---- dispatch ------------------------------------------------------

    def schedule_batch(self, snapshot, pods, **kw):
        raise NotImplementedError

    def schedule_windows(self, snapshot, pods_windows, **kw):
        raise NotImplementedError

    def schedule_batch_async(self, snapshot, pods, **kw):
        """schedule_batch, returning once the cycle is enqueued: the
        pipelined loop's handle (engine.pending_on on `device`)."""
        return self._pending(self.schedule_batch(snapshot, pods, **kw))

    def _pending(self, result):
        from kubernetes_scheduler_tpu_torch.engine import pending_on

        return pending_on(result, self.device)

    # ---- resident cluster state (where supports_resident()) -----------

    def supports_resident(self) -> bool:
        return False

    def supports_windows_resident(self) -> bool:
        return False

    def schedule_resident(self, snapshot, pods, *, delta=None, epoch=0, **kw):
        raise NotImplementedError

    def schedule_resident_async(self, snapshot, pods, *, delta=None, epoch=0, **kw):
        return self._pending(
            self.schedule_resident(snapshot, pods, delta=delta, epoch=epoch, **kw)
        )

    def schedule_windows_resident(self, snapshot, pods_windows, *, delta=None, epoch=0, **kw):
        raise NotImplementedError

    def invalidate_resident(self) -> None:
        pass

    def supports_fleet(self) -> bool:
        """Whether schedule_batch_fleet serves the pool's coalesced
        groups in one call."""
        return False

    def schedule_batch_fleet(self, snapshot, requests, *, delta=None, epoch=None, **kw):
        raise NotImplementedError

    # ---- capabilities ------------------------------------------------------

    def supports_fused_min_max(self) -> bool:
        return False

    def supports_gangs(self) -> bool:
        return False

    def preempt(self, snapshot, pods, victims, *, k_cap: int):
        """The preemption pass on the engine's device; None where the
        engine does not run it."""
        return None

    # ---- telemetry and lifetime -----------------------------------------

    def set_trace_id(self, trace_id: int, seq: int = -1) -> None:
        pass

    def arm_profile(self, cycles: int, out_dir: str | None = None) -> dict:
        return {"armed": 0, "error": "engine has no profile surface"}

    def healthy(self) -> bool:
        return True

    def health_info(self):
        return None

    def close(self) -> None:
        pass
