"""Selector axes wider than MAX_FUSED_SELECTORS (32) against the JAX
package, at S = 40. With affinity_aware=False the kernel path folds no
selector rows and evaluates the count-based families (pod affinity,
reverse avoiders, hard spread) outside the kernel, into its `other`
operand; with affinity_aware=True the kernel runs without selector rows
and the assigners hold those families against live counts, as at any S.
Masks and decisions are exact (greedy: or a near-tie flip, see
tests/test_torch_engine_affinity.py); scores as in
tests/test_torch_policies.py.
"""

import numpy as np
import pytest
import torch

from kubernetes_scheduler_tpu import engine as ref
from kubernetes_scheduler_tpu.sim import gen_cluster as ref_cluster
from kubernetes_scheduler_tpu.sim import gen_pods as ref_pods
from kubernetes_scheduler_tpu_torch import TorchEngine, engine
from kubernetes_scheduler_tpu_torch.ops.fused import MAX_FUSED_SELECTORS
from kubernetes_scheduler_tpu_torch.sim import gen_cluster, gen_pods
from tests.test_torch_policies import ASSIGNER_IDS, assert_cycle

S = 40
FEATS = dict(constraints=True, n_selectors=S)


@pytest.fixture(scope="module")
def problem():
    """A 200-node cluster and 96 pods over 40 selectors: required and
    forbidden selectors on ~15% of the pods each, base counts on ~30% of
    the (node, selector) cells, running avoiders on ~3%."""
    return (
        ref_cluster(200, seed=3, **FEATS), ref_pods(96, seed=4, **FEATS),
        gen_cluster(200, seed=3, device="cpu", **FEATS),
        gen_pods(96, seed=4, device="cpu", **FEATS),
    )


def test_torch_wide_selector_operands_leave_the_kernel(problem):
    _, _, ts, tp = problem
    assert ts.domain_counts.shape[1] == S > MAX_FUSED_SELECTORS
    for include in (True, False):
        ops = engine.fused_score_operands(ts, tp, include_pod_affinity=include)
        assert ops["aff_pod"] is None and ops["aff_node"] is None
        assert torch.equal(ops["pod_mask"], tp.pod_mask)
        want = engine.other_fit(ts, tp)
        if include:
            want = want & engine.count_families_fit(ts, tp)
        assert torch.equal(ops["other"], want.float())
    # the count-based families exclude cells here
    assert not bool(engine.count_families_fit(ts, tp).all())


CASES = [(a, aa) for aa in (True, False) for a in ("greedy", "auction")]


@pytest.mark.parametrize(
    "assigner,affinity_aware", CASES,
    ids=[f"{ASSIGNER_IDS[a]}-{'live' if aa else 'static'}" for a, aa in CASES],
)
def test_torch_wide_selector_cycle_matches_reference(problem, assigner, affinity_aware):
    rs, rp, ts, tp = problem
    kw = dict(assigner=assigner, normalizer="min_max", fused=True,
              affinity_aware=affinity_aware)
    want = ref.schedule_batch(rs, rp, **kw)
    got = TorchEngine(device="cpu").schedule_batch(ts, tp, **kw)
    assert 0 < int(got.n_assigned)
    assert_cycle(got, want, ts, tp, rp, kw)


@pytest.mark.parametrize("assigner", ["greedy", "auction"], ids=["scan", "bid"])
def test_torch_wide_selector_backlog_matches_reference(problem, assigner):
    rs, rp, ts, tp = problem
    kw = dict(assigner=assigner, normalizer="min_max", fused=True, affinity_aware=True)
    want = ref.schedule_windows(rs, ref.stack_windows(rp, 32), **kw)
    got = engine.schedule_windows(ts, engine.stack_windows(tp, 32), **kw)
    assert int(got.n_assigned) > 0
    np.testing.assert_array_equal(got.node_idx.numpy(), np.asarray(want.node_idx))
    assert int(got.n_assigned) == int(want.n_assigned)
    np.testing.assert_array_equal(got.free_after.numpy().view(np.uint32),
                                  np.asarray(want.free_after).view(np.uint32))
