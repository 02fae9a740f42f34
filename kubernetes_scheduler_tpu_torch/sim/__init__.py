from kubernetes_scheduler_tpu_torch.sim.cluster_gen import (
    BENCH_CONFIGS,
    gen_cluster,
    gen_config,
    gen_pods,
)

__all__ = ["BENCH_CONFIGS", "gen_cluster", "gen_config", "gen_pods"]
