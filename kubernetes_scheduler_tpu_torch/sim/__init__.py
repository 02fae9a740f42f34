from kubernetes_scheduler_tpu_torch.sim.cluster_gen import (
    BENCH_CONFIGS,
    gen_cluster,
    gen_config,
    gen_pods,
)
from kubernetes_scheduler_tpu_torch.sim.host_gen import (
    gen_host_cluster,
    gen_host_pods,
)

__all__ = [
    "BENCH_CONFIGS", "gen_cluster", "gen_config", "gen_host_cluster",
    "gen_host_pods", "gen_pods",
]
