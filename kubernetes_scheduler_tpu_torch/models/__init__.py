"""Scheduling-policy "model families".

Two families:
- heuristic: the reference's four scoring formulas as selectable policies
  (the live BalancedCpuDiskIO plus the three dead/legacy alternates,
  pkg/yoda/score/algorithm.go) — zero parameters, pure kernels.
- learned: a trainable two-tower scorer over pod/node features
  (models/learned.py), resolved on first use so that importing the
  registry does not build the engine.
"""

from kubernetes_scheduler_tpu_torch._exports import lazy_getattr, names_in
from kubernetes_scheduler_tpu_torch.models.policy import (
    HEURISTIC_POLICIES,
    POLICY_REGISTRY,
    PolicyInfo,
    get_policy,
)

_EXPORTS = names_in(
    "kubernetes_scheduler_tpu_torch.models.learned",
    "make_features",
    "Tower",
    "NodeScorer",
    "TrainState",
    "init_train_state",
    "imitation_loss",
    "train_step",
    "sharded_train_step",
    "save_checkpoint",
    "restore_checkpoint",
    "LearnedEngine",
    "load_learned_engine",
    "make_sharded_learned_fn",
    "sharded_learned_score_fn",
)
__all__ = ["HEURISTIC_POLICIES", "POLICY_REGISTRY", "PolicyInfo", "get_policy",
           *_EXPORTS]
__getattr__ = lazy_getattr(_EXPORTS)
