"""The host layer of the port (counterpart of kubernetes_scheduler_tpu/host/):
typed cluster objects, the snapshot builder, the metrics advisor, the
per-cycle cache, the scheduling queue and the scheduling loop. The
re-exports are the reference's, resolved on first use."""

from kubernetes_scheduler_tpu_torch._exports import lazy_getattr, names_in

_EXPORTS = {
    **names_in("kubernetes_scheduler_tpu_torch.host.types",
               "Card", "Container", "Node", "Pod", "Taint", "Toleration"),
    **names_in("kubernetes_scheduler_tpu_torch.host.snapshot", "SnapshotBuilder"),
    **names_in("kubernetes_scheduler_tpu_torch.host.advisor",
               "NodeUtil", "PrometheusAdvisor", "StaticAdvisor"),
    **names_in("kubernetes_scheduler_tpu_torch.host.cache", "CycleCache"),
    **names_in("kubernetes_scheduler_tpu_torch.host.queue", "SchedulingQueue"),
    **names_in("kubernetes_scheduler_tpu_torch.host.scheduler",
               "RecordingBinder", "RecordingEvictor", "Scheduler"),
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_getattr(_EXPORTS)
