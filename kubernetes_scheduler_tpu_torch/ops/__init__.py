"""Per-op PyTorch counterparts of kubernetes_scheduler_tpu/ops, one module
each, plus the hand-written CUDA kernels of the fused path (`fused.py`)."""
