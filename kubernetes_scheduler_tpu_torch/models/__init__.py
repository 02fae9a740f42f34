"""Scheduling-policy "model families".

Two families:
- heuristic: the reference's four scoring formulas as selectable policies
  (the live BalancedCpuDiskIO plus the three dead/legacy alternates,
  pkg/yoda/score/algorithm.go) — zero parameters, pure kernels.
- learned: a trainable two-tower scorer over pod/node features
  (kubernetes_scheduler_tpu/models/learned.py).

The port exports the heuristic half. The learned half is not ported yet:
its names (NodeScorer, TrainState, init_train_state, make_features,
train_step, LearnedEngine, load_learned_engine, ...) raise
NotImplementedError naming ROADMAP queue A item 9.
"""

from kubernetes_scheduler_tpu_torch.models.policy import (
    HEURISTIC_POLICIES,
    POLICY_REGISTRY,
    PolicyInfo,
    get_policy,
)

LEARNED_NAMES = (
    "make_features",
    "Tower",
    "NodeScorer",
    "TrainState",
    "init_train_state",
    "imitation_loss",
    "train_step",
    "save_checkpoint",
    "restore_checkpoint",
    "LearnedEngine",
    "load_learned_engine",
    "make_sharded_learned_fn",
)

__all__ = ["HEURISTIC_POLICIES", "POLICY_REGISTRY", "PolicyInfo", "get_policy"]


def __getattr__(name):
    if name in LEARNED_NAMES:
        raise NotImplementedError(
            f"models.{name}: the learned scorer is not ported to the PyTorch "
            "package yet: ROADMAP queue A, item 9 (the learned scorer)"
        )
    raise AttributeError(name)
