"""PyTorch/CUDA port of the batch scheduling engine (kubernetes_scheduler_tpu).

The JAX package stays the reference; this package mirrors its module names
so each function's counterpart is easy to find. It imports torch and never
jax. The fused score/feasibility pass and the auction's bid head run as
hand-written CUDA kernels for Hopper (`ops/fused.py`, `csrc/fused.cu`);
on CPU tensors every kernel wrapper runs its plain PyTorch version.

Entry points run on the CUDA card unless the caller passes
`device="cpu"`; they never fall back to the CPU on their own.
"""

# the exports resolve lazily: importing them pulls in torch, which the
# journal and span tools (trace.inspect, .spans, .analyze, .trend) must
# not need just for the package import
_EXPORTS = {
    "resolve_device": "kubernetes_scheduler_tpu_torch.device",
    **{
        name: "kubernetes_scheduler_tpu_torch.engine"
        for name in (
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
        )
    },
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(module), name)
