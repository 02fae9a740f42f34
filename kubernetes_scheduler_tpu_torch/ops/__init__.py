"""Per-op PyTorch counterparts of kubernetes_scheduler_tpu/ops, one module
each, plus the hand-written CUDA kernels of the fused path (`fused.py`).
The re-exports are the reference's, resolved on first use."""

from kubernetes_scheduler_tpu_torch._exports import lazy_getattr, names_in

_OPS = "kubernetes_scheduler_tpu_torch.ops"
_EXPORTS = {
    **names_in(f"{_OPS}.resources", "resources"),
    **names_in(f"{_OPS}.stats", "utilization_stats"),
    **names_in(f"{_OPS}.score",
               "balanced_cpu_diskio", "balanced_diskio", "free_capacity", "card_score"),
    **names_in(f"{_OPS}.normalize", "min_max_normalize", "softmax_normalize"),
    **names_in(f"{_OPS}.feasibility", "resource_fit", "card_fit"),
    **names_in(f"{_OPS}.collect", "collect_max_card_values"),
    **names_in(f"{_OPS}.assign", "greedy_assign"),
    **names_in(f"{_OPS}.constraints",
               "node_affinity_fit", "pod_affinity_fit", "taint_toleration_fit"),
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_getattr(_EXPORTS)
