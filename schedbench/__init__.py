"""The benchmark of kubernetes_scheduler_tpu_torch: its deployed host loop
(host.scheduler.Scheduler over TorchEngine on a CUDA card) on
scheduler_perf deployments. See README.md and BENCHMARK.json."""
