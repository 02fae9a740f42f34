"""The port's weighted multi-plugin score (engine.combine_scores and
schedule_batch / schedule_windows with score_plugins) against the JAX
package: the upstream framework's sum of weighted scorers, the
reference's production score. The plugins are the JAX bench's four
(bench.py: yoda's balanced_cpu_diskio at weight 2 beside the k8s 1.22
defaults least_allocated, balanced_allocation and image_locality at 1) on
a cluster with images.

Tolerance (chip_smoke.score_tolerance): each plugin's score as in
tests/test_torch_policies.py (raw, or min-max normalized for a plugin
outside PRESCALED_PLUGINS), times |weight|, summed, plus 8 ulp of the
total's scale for the sum's own rounding. Masks and decisions are exact
(greedy: or a near-tie flip).
"""

import numpy as np
import pytest

from chip_smoke import score_tolerance
from kubernetes_scheduler_tpu import engine as ref
from kubernetes_scheduler_tpu.sim import gen_cluster as ref_cluster
from kubernetes_scheduler_tpu.sim import gen_pods as ref_pods
from kubernetes_scheduler_tpu_torch import TorchEngine, engine
from kubernetes_scheduler_tpu_torch.sim import gen_cluster, gen_pods
from tests.test_torch_policies import ASSIGNER_IDS, assert_close, assert_cycle

BENCH_PLUGINS = (
    ("balanced_cpu_diskio", 2.0), ("least_allocated", 1.0),
    ("balanced_allocation", 1.0), ("image_locality", 1.0),
)
# plugins on both sides of PRESCALED_PLUGINS, with weights that are not
# powers of two
MIXED_PLUGINS = (
    ("card", 0.7), ("balanced_diskio", 1.5), ("free_capacity", 3.0),
    ("least_allocated", 0.25),
)
FEATURES = dict(gpu=True, constraints=True, images=True)


@pytest.fixture(scope="module")
def problem():
    return (
        ref_cluster(300, seed=5, **FEATURES), ref_pods(96, seed=6, **FEATURES),
        gen_cluster(300, seed=5, device="cpu", **FEATURES),
        gen_pods(96, seed=6, device="cpu", **FEATURES),
    )


def test_torch_engine_option_tables_match_reference():
    assert engine.POLICIES == ref.POLICIES
    assert engine.ASSIGNERS == ref.ASSIGNERS
    assert engine.NORMALIZERS == ref.NORMALIZERS
    assert engine.PRESCALED_PLUGINS == ref.PRESCALED_PLUGINS


@pytest.mark.parametrize("plugins", [BENCH_PLUGINS, MIXED_PLUGINS], ids=["bench", "mixed"])
def test_torch_combine_scores_matches_reference(problem, plugins):
    rs, rp, ts, tp = problem
    want = np.asarray(ref.combine_scores(rs, rp, plugins))
    got = engine.combine_scores(ts, tp, plugins)
    everywhere = np.ones(want.shape, bool)
    tol = score_tolerance(ts, tp, want, everywhere, dict(score_plugins=plugins))
    assert_close(got.numpy(), want, tol, plugins)
    with pytest.raises(ValueError, match="at least one"):
        engine.combine_scores(ts, tp, ())


PLUGIN_CYCLES = [("auction", True), ("greedy", False), ("auction", False)]


@pytest.mark.parametrize(
    "assigner,affinity_aware", PLUGIN_CYCLES,
    ids=[f"{ASSIGNER_IDS[a]}-{'live' if aa else 'static'}" for a, aa in PLUGIN_CYCLES],
)
def test_torch_plugins_cycle_matches_reference(problem, assigner, affinity_aware):
    rs, rp, ts, tp = problem
    kw = dict(assigner=assigner, fused=False, affinity_aware=affinity_aware,
              score_plugins=BENCH_PLUGINS)
    want = ref.schedule_batch(rs, rp, **kw)
    # policy and normalizer are ignored under score_plugins
    got = TorchEngine(device="cpu").schedule_batch(ts, tp, policy="card",
                                                    normalizer="softmax", **kw)
    assert int(got.n_assigned) > 0
    assert_cycle(got, want, ts, tp, rp, kw)


def test_torch_plugins_reject_the_kernel_path(problem):
    _, _, ts, tp = problem
    with pytest.raises(ValueError, match="score_plugins"):
        engine.schedule_batch(ts, tp, fused=True, score_plugins=BENCH_PLUGINS)


def test_torch_plugins_backlog_matches_reference(problem):
    rs, rp, ts, tp = problem
    kw = dict(assigner="auction", fused=False, affinity_aware=False,
              score_plugins=BENCH_PLUGINS)
    want = ref.schedule_windows(rs, ref.stack_windows(rp, 32), **kw)
    got = engine.schedule_windows(ts, engine.stack_windows(tp, 32), **kw)
    assert int(got.n_assigned) > 0
    np.testing.assert_array_equal(got.node_idx.numpy(), np.asarray(want.node_idx))
    assert int(got.n_assigned) == int(want.n_assigned)
    np.testing.assert_array_equal(got.free_after.numpy().view(np.uint32),
                                  np.asarray(want.free_after).view(np.uint32))
