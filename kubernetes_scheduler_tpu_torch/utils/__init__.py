"""Configuration and padding helpers (counterpart of
kubernetes_scheduler_tpu/utils/); the re-exports resolve on first use."""

from kubernetes_scheduler_tpu_torch._exports import lazy_getattr, names_in

_EXPORTS = names_in("kubernetes_scheduler_tpu_torch.utils.padding",
                    "bucket_size", "pad_axis", "pad_to_bucket")
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_getattr(_EXPORTS)
