"""PyTorch/CUDA port of the batch scheduling engine (kubernetes_scheduler_tpu).

The JAX package stays the reference; this package mirrors its module names
so each function's counterpart is easy to find. It imports torch and never
jax. The fused score/feasibility pass and the auction's bid head run as
hand-written CUDA kernels for Hopper (`ops/fused.py`, `csrc/fused.cu`);
on CPU tensors every kernel wrapper runs its plain PyTorch version.

Entry points run on the CUDA card unless the caller passes
`device="cpu"`; they never fall back to the CPU on their own.
"""

from kubernetes_scheduler_tpu_torch._exports import lazy_getattr, names_in

__version__ = "0.1.0"

_EXPORTS = {
    **names_in("kubernetes_scheduler_tpu_torch.device", "resolve_device"),
    **names_in(
        "kubernetes_scheduler_tpu_torch.engine",
        "PodBatch",
        "ScheduleResult",
        "SnapshotArrays",
        "TorchEngine",
        "WindowsResult",
        "make_pod_batch",
        "make_snapshot",
        "schedule_batch",
        "schedule_windows",
        "stack_windows",
    ),
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_getattr(_EXPORTS)
