"""Device-step profiling (counterpart of kubernetes_scheduler_tpu/host/observe.py's
profile_device_step, the part of that module the engine uses)."""

from __future__ import annotations

import os

import torch


def profile_device_step(engine_call, out_dir: str):
    """Run one engine call under torch.profiler, wait for the device, and
    write the call's Chrome trace to <out_dir>/trace.json (kernels, memcpys
    and host ops on one timeline). Returns the call's result."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        result = engine_call()
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    return result
