"""Each main-path op of the port (kubernetes_scheduler_tpu_torch/ops)
against its JAX twin, on the same numpy inputs made from a seed.

Everything is exact except where a float expression is rounded
differently: XLA on the CPU contracts the policy score's products into
FMAs (4 ulp of MAX_RAW_SCORE allowed), and the masked mean and variance
of utilization_stats sum in another order (relative 1e-6).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kubernetes_scheduler_tpu.ops import assign as rassign
from kubernetes_scheduler_tpu.ops import constraints as rcons
from kubernetes_scheduler_tpu.ops import feasibility as rfeas
from kubernetes_scheduler_tpu.ops import gang as rgang
from kubernetes_scheduler_tpu.ops import normalize as rnorm
from kubernetes_scheduler_tpu.ops import score as rscore
from kubernetes_scheduler_tpu.ops import stats as rstats
from kubernetes_scheduler_tpu.sim import gen_cluster, gen_pods
from kubernetes_scheduler_tpu_torch.ops import assign, constraints, feasibility
from kubernetes_scheduler_tpu_torch.ops import gang, normalize, score, stats

ULP10 = float(np.spacing(np.float32(10.0)))


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def cluster():
    """(snapshot, pods) numpy leaves of a constraints + GPU cluster."""
    snap = gen_cluster(120, seed=5, gpu=True, constraints=True)
    pods = gen_pods(40, seed=6, gpu=True, constraints=True)
    return (
        {k: N(v) for k, v in snap._asdict().items()},
        {k: N(v) for k, v in pods._asdict().items()},
    )


def test_torch_utilization_stats_matches_reference():
    rng = np.random.default_rng(0)
    disk = rng.gamma(2.0, 8.0, 97).clip(0, 50).astype(np.float32)
    cpu = rng.uniform(0, 100, 97).astype(np.float32)
    mask = rng.uniform(size=97) > 0.2
    want = rstats.utilization_stats(jnp.asarray(disk), jnp.asarray(cpu), jnp.asarray(mask))
    got = stats.utilization_stats(T(disk), T(cpu), T(mask))
    np.testing.assert_array_equal(got.u.numpy(), N(want.u))
    np.testing.assert_array_equal(got.v.numpy(), N(want.v))
    np.testing.assert_array_equal(got.n_valid.numpy(), N(want.n_valid))
    np.testing.assert_allclose(got.u_avg.numpy(), N(want.u_avg), rtol=1e-6)
    np.testing.assert_allclose(got.m_var.numpy(), N(want.m_var), rtol=1e-5)


def test_torch_policy_score_matches_reference():
    rng = np.random.default_rng(1)
    r_cpu = rng.choice([100, 250, 500, 1000], 33).astype(np.float32)
    r_io = rng.gamma(2.0, 5.0, 33).clip(0.1, 45).astype(np.float32)
    r_io[::4] = 0.0  # missing diskIO annotation: beta = 0, alpha = 1
    a_want, b_want = rscore.alpha_beta(jnp.asarray(r_cpu), jnp.asarray(r_io))
    a_got, b_got = score.alpha_beta(T(r_cpu), T(r_io))
    np.testing.assert_array_equal(a_got.numpy(), N(a_want))
    np.testing.assert_array_equal(b_got.numpy(), N(b_want))
    assert (b_got.numpy()[::4] == 0).all() and (a_got.numpy()[::4] == 1).all()

    disk = rng.uniform(0, 50, 70).astype(np.float32)
    cpu = rng.uniform(0, 100, 70).astype(np.float32)
    mask = np.ones(70, bool)
    want = rscore.balanced_cpu_diskio(
        rstats.utilization_stats(jnp.asarray(disk), jnp.asarray(cpu), jnp.asarray(mask)),
        jnp.asarray(r_cpu), jnp.asarray(r_io),
    )
    got = score.balanced_cpu_diskio(
        stats.utilization_stats(T(disk), T(cpu), T(mask)), T(r_cpu), T(r_io)
    )
    np.testing.assert_allclose(got.numpy(), N(want), rtol=0, atol=4 * ULP10)


def test_torch_min_max_normalize_matches_reference():
    rng = np.random.default_rng(2)
    scores = rng.uniform(-3, 10, (9, 50)).astype(np.float32)
    scores[2] = 4.0                      # highest == lowest guard
    scores[3] = -2.0                     # all-negative row: highest floors at 0
    mask = rng.uniform(size=50) > 0.2
    hi_w, lo_w = rnorm.score_bounds(jnp.asarray(scores), jnp.asarray(mask))
    hi_g, lo_g = normalize.score_bounds(T(scores), T(mask))
    np.testing.assert_array_equal(hi_g.numpy(), N(hi_w))
    np.testing.assert_array_equal(lo_g.numpy(), N(lo_w))
    want = rnorm.min_max_normalize(jnp.asarray(scores), jnp.asarray(mask))
    got = normalize.min_max_normalize(T(scores), T(mask))
    np.testing.assert_array_equal(got.numpy(), N(want))


def test_torch_resource_and_card_fit_match_reference(cluster):
    snap, pods = cluster
    want = rfeas.resource_fit(
        snap["allocatable"], snap["requested"], pods["request"], snap["node_mask"]
    )
    got = feasibility.resource_fit(
        T(snap["allocatable"]), T(snap["requested"]), T(pods["request"]),
        T(snap["node_mask"]),
    )
    np.testing.assert_array_equal(got.numpy(), N(want))
    args = [snap[k] for k in ("cards", "card_mask", "card_healthy")] + [
        pods[k] for k in ("want_number", "want_memory", "want_clock")
    ]
    fits_w, per_w = rfeas.card_fit(*[jnp.asarray(a) for a in args])
    fits_g, per_g = feasibility.card_fit(*[T(a) for a in args])
    np.testing.assert_array_equal(fits_g.numpy(), N(fits_w))
    np.testing.assert_array_equal(per_g.numpy(), N(per_w))
    assert 0 < fits_g.numpy().mean() < 1


def test_torch_taint_and_affinity_masks_match_reference(cluster):
    snap, pods = cluster
    t_args = (snap["taints"], snap["taint_mask"], pods["tolerations"], pods["tol_mask"])
    want = rcons.taint_toleration_fit(*[jnp.asarray(a) for a in t_args])
    got = constraints.taint_toleration_fit(*[T(a) for a in t_args])
    np.testing.assert_array_equal(got.numpy(), N(want))
    assert 0 < got.numpy().mean() < 1

    na = [snap["node_labels"], snap["node_label_mask"]] + [
        pods[k] for k in ("na_key", "na_op", "na_vals", "na_val_mask", "na_mask", "na_term")
    ]
    na[4] = np.random.default_rng(3).integers(0, 4, na[4].shape).astype(np.int32)  # all ops
    want = rcons.node_affinity_fit(*[jnp.asarray(a) for a in na])
    got = constraints.node_affinity_fit(*[T(a) for a in na])
    np.testing.assert_array_equal(got.numpy(), N(want))
    assert 0 < got.numpy().mean() < 1

    target = np.array([-1, 0, 5, 119, 120, 400, -1], np.int32)
    want = rcons.node_name_fit(jnp.asarray(target), 120)
    got = constraints.node_name_fit(T(target), 120)
    np.testing.assert_array_equal(got.numpy(), N(want))


def test_torch_tie_jitter_bitwise():
    for p, n, scale in ((7, 300, 0.01), (64, 1025, 0.01), (1030, 70, 0.5)):
        want = N(rassign.tie_jitter(p, n, scale))
        got = assign.tie_jitter(p, n, scale, device=torch.device("cpu"))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_torch_priority_order_and_onehot_match_reference():
    rng = np.random.default_rng(4)
    prio = rng.integers(-3, 4, 50).astype(np.int32)
    mask = rng.uniform(size=50) > 0.2
    want = rassign._priority_order(jnp.asarray(prio), jnp.asarray(mask))
    got = assign._priority_order(T(prio), T(mask))
    np.testing.assert_array_equal(got.numpy(), N(want))
    sel = rng.integers(-1, 6, (50, 3)).astype(np.int32)
    want = rassign.pod_has_anti_onehot(jnp.asarray(sel), 6)
    got = assign.pod_has_anti_onehot(T(sel), 6)
    np.testing.assert_array_equal(got.numpy(), N(want))


def test_torch_segmented_admission_matches_reference():
    rng = np.random.default_rng(5)
    p, n, r = 80, 9, 3
    # quarter-unit requests: prefix sums are exact in any grouping
    req = (rng.integers(0, 12, (p, r)) / 4.0).astype(np.float32)
    req[rng.uniform(size=(p, r)) < 0.2] = 0.0
    free = (rng.integers(0, 30, (n, r)) / 4.0).astype(np.float32)
    bid = rng.integers(0, n, p).astype(np.int32)
    has = rng.uniform(size=p) > 0.25
    prio = rng.integers(0, 4, p).astype(np.int32)
    by_prio = rassign._priority_order(jnp.asarray(prio), jnp.ones(p, bool))
    want = rassign._segmented_admission(
        jnp.asarray(bid), jnp.asarray(has), jnp.asarray(req), jnp.asarray(free), by_prio
    )
    got = assign._segmented_admission(T(bid), T(has), T(req), T(free), T(N(by_prio)))
    np.testing.assert_array_equal(got.numpy(), N(want))
    assert 0 < got.numpy().sum() < has.sum()  # contention rejects some bidders


def test_torch_gang_mask_matches_reference():
    rng = np.random.default_rng(6)
    p, n, r = 12, 5, 3
    gang_id = np.array([0, 0, 0, 1, 1, -1, 2, 2, 2, -1, 3, 3], np.int32)
    gang_size = np.array([3, 3, 3, 2, 2, 0, 3, 3, 3, 0, 2, 2], np.int32)
    pod_mask = np.ones(p, bool)
    node_idx = np.array([0, 1, 2, 3, -1, 4, 0, 1, -1, 2, 3, 3], np.int32)  # gangs 1, 2 partial
    req = rng.integers(1, 5, (p, r)).astype(np.float32)
    free = rng.integers(0, 10, (n, r)).astype(np.float32)
    n_asg = np.int32((node_idx >= 0).sum())
    args = (gang_id, gang_size, pod_mask, node_idx, req, free, n_asg)
    want = rgang.gang_mask_assign(*[jnp.asarray(a) for a in args])
    got = gang.gang_mask_assign(*[T(a) for a in args])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), N(w))
    assert (got[0].numpy()[[3, 6, 7]] <= -2).all()  # rescinded, decodable
    # a gang-free window passes through bit-identical
    none = np.full(p, -1, np.int32)
    got = gang.gang_mask_assign(T(none), T(gang_size), T(pod_mask), T(node_idx),
                                T(req), T(free), T(n_asg))
    np.testing.assert_array_equal(got[0].numpy(), node_idx)
    np.testing.assert_array_equal(got[1].numpy(), free)
