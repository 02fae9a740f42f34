"""The port's engine (kubernetes_scheduler_tpu_torch.engine) against the JAX
engine with the options of the second slice: greedy with affinity off
(kernel K4) and on, and the auction with affinity on, through
schedule_batch and schedule_windows on the generated gpu and constraints
clusters.

Tolerance. Decisions, n_assigned and free_after must be equal, free_after
bitwise. The fused scores themselves differ by up to an ulp of
MAX_RAW_SCORE (XLA on the CPU contracts the policy score into FMAs, the
port does not; tests/test_torch_kernels.py pins that bound), and greedy
has no tie jitter, so a near-tie could flip a greedy pick. Should a
decision differ, the test accepts it only as such a flip: up to the first
divergent pod (in priority order, in the first divergent window) every
decision is equal, and at that pod the port's pick scores within 2 * d of
the reference's pick under the reference's scores, d being the largest
|port - reference| score difference in that pod's row.
"""

import numpy as np
import pytest

from kubernetes_scheduler_tpu import engine as ref
from kubernetes_scheduler_tpu.ops import assign as rassign
from kubernetes_scheduler_tpu.sim import gen_cluster as ref_cluster
from kubernetes_scheduler_tpu.sim import gen_pods as ref_pods
from kubernetes_scheduler_tpu_torch import TorchEngine, engine
from kubernetes_scheduler_tpu_torch.sim import gen_cluster, gen_pods

BASE = dict(normalizer="min_max", fused=True)
OPTIONS = {
    "greedy": dict(BASE, assigner="greedy", affinity_aware=False),
    "greedy-affinity": dict(BASE, assigner="greedy", affinity_aware=True),
    "bid-affinity": dict(BASE, assigner="auction", affinity_aware=True),
}
FEATURES = {"gpu": {"gpu": True}, "constraints": {"constraints": True}}
CASES = [(f, o) for f in sorted(FEATURES) for o in OPTIONS]


def _problem(features, n_nodes=300, n_pods=96, seed=3):
    feats = FEATURES[features]
    return (
        ref_cluster(n_nodes, seed=seed, **feats), ref_pods(n_pods, seed=seed + 1, **feats),
        gen_cluster(n_nodes, seed=seed, device="cpu", **feats),
        gen_pods(n_pods, seed=seed + 1, device="cpu", **feats),
    )


def _near_tie(got, want, pods_np, what):
    """A differing greedy decision is accepted only as a near-tie flip at
    the first divergent pod in priority order (see the module docstring)."""
    g_idx, w_idx = got.node_idx.numpy(), np.asarray(want.node_idx)
    order = np.asarray(rassign._priority_order(pods_np.priority, pods_np.pod_mask))
    first = next(i for i in order if g_idx[i] != w_idx[i])
    ref_row = np.asarray(want.scores)[first].astype(np.float64)
    d = np.abs(got.scores.numpy()[first] - ref_row)[np.asarray(want.feasible)[first]].max()
    assert g_idx[first] >= 0 and w_idx[first] >= 0, (what, first)
    assert ref_row[g_idx[first]] >= ref_row[w_idx[first]] - 2 * d, (what, first, d)


def _assert_batch(got, want, pods_np, assigner, what):
    np.testing.assert_array_equal(got.feasible.numpy(), np.asarray(want.feasible))
    if assigner == "greedy" and not np.array_equal(got.node_idx.numpy(), np.asarray(want.node_idx)):
        _near_tie(got, want, pods_np, what)
        return
    np.testing.assert_array_equal(got.node_idx.numpy(), np.asarray(want.node_idx), err_msg=what)
    assert int(got.n_assigned) == int(want.n_assigned)
    np.testing.assert_array_equal(
        got.free_after.numpy().view(np.uint32),
        np.asarray(want.free_after).view(np.uint32), err_msg=what,
    )


@pytest.mark.parametrize("features,option", CASES, ids=[f"{f}-{o}" for f, o in CASES])
def test_torch_cycle_new_options_match_reference(features, option):
    kw = OPTIONS[option]
    rs, rp, ts, tp = _problem(features)
    want = ref.schedule_batch(rs, rp, **kw)
    got = TorchEngine(device="cpu").schedule_batch(ts, tp, **kw)
    assert int(got.n_assigned) > 0
    _assert_batch(got, want, rp, kw["assigner"], f"{features}-{option}")


def _first_divergent_window(ts, tp_w, rs, rp_w, kw, got, want):
    """Replay the backlog window by window from the (equal) state the
    windows before the first divergent one left, and hold that window
    with the near-tie rule."""
    w_first = next(w for w in range(got.node_idx.shape[0])
                   if not np.array_equal(got.node_idx[w].numpy(), np.asarray(want.node_idx[w])))
    snap = ts
    for w in range(w_first + 1):
        window = type(tp_w)(*[f[w] for f in tp_w])
        res = engine.schedule_batch(snap, window, **kw)
        if w < w_first:
            counts = engine.fold_window_counts(ts, window, res.node_idx,
                                               snap.domain_counts, snap.avoid_counts)
            snap = snap._replace(requested=ts.allocatable - res.free_after,
                                 domain_counts=counts[0], avoid_counts=counts[1])
    r_snap = type(rs)(*[np.asarray(f.numpy()) for f in snap])
    r_window = type(rp_w)(*[np.asarray(f)[w_first] for f in rp_w])
    want_w = ref.schedule_batch(r_snap, r_window, **kw)
    _assert_batch(res, want_w, r_window, kw["assigner"], f"window {w_first}")


@pytest.mark.parametrize("features,option", CASES, ids=[f"{f}-{o}" for f, o in CASES])
def test_torch_backlog_new_options_match_reference(features, option):
    kw = OPTIONS[option]
    rs, rp, ts, tp = _problem(features)
    rp_w, tp_w = ref.stack_windows(rp, 32), engine.stack_windows(tp, 32)
    want = ref.schedule_windows(rs, rp_w, **kw)
    got = TorchEngine(device="cpu").schedule_windows(ts, tp_w, **kw)
    assert tuple(got.node_idx.shape) == (3, 32) and int(got.n_assigned) > 0
    if kw["assigner"] == "greedy" and not np.array_equal(
            got.node_idx.numpy(), np.asarray(want.node_idx)):
        _first_divergent_window(ts, tp_w, rs, rp_w, kw, got, want)
        return
    np.testing.assert_array_equal(got.node_idx.numpy(), np.asarray(want.node_idx))
    assert int(got.n_assigned) == int(want.n_assigned)
    np.testing.assert_array_equal(
        got.free_after.numpy().view(np.uint32), np.asarray(want.free_after).view(np.uint32)
    )


@pytest.mark.parametrize("assigner", ["greedy", "auction"], ids=["greedy", "bid"])
def test_torch_backlog_affinity_tables_restart_each_window(assigner):
    """Window 2 sees window 1's placement once, through the carried domain
    counts: the in-window tables start at zero in every window. Pod A
    (window 1) matches selector 0 and lands in domain X (nodes 0-3); pod B
    (window 2) spreads selector 0 with maxSkew 2 and prefers node 0: counts
    X=1, Y=0 give skew 2 there, allowed. A count of A carried twice would
    give skew 3 and push B to domain Y."""
    n, s = 8, 1
    dom = np.repeat([0, 4], 4)[:, None].astype(np.int32)
    snap = engine.make_snapshot(
        np.full((n, 3), 100.0, np.float32), np.zeros((n, 3), np.float32),
        np.zeros(n, np.float32), np.arange(n, dtype=np.float32) * 10,  # node 0 scores best
        np.zeros(n, np.float32),
        domain_counts=np.zeros((n, s), np.float32), domain_id=dom, device="cpu",
    )
    pods = engine.make_pod_batch(
        np.ones((2, 3), np.float32), pod_matches=np.array([[True], [False]]),
        spread_sel=np.array([[-1], [0]], np.int32), spread_max=np.array([[1], [2]], np.int32),
        target_node=np.array([0, -1], np.int32), device="cpu",
    )
    kw = dict(BASE, assigner=assigner, affinity_aware=True)
    got = engine.schedule_windows(snap, engine.stack_windows(pods, 1), **kw)
    assert got.node_idx.numpy()[0, 0] == 0
    assert 0 <= got.node_idx.numpy()[1, 0] < 4
    rs = ref.make_snapshot(*[np.asarray(f.numpy()) for f in snap[:5]],
                           **{k: np.asarray(getattr(snap, k).numpy())
                              for k in snap._fields[5:]})
    rp = ref.make_pod_batch(**{k: np.asarray(v.numpy()) for k, v in pods._asdict().items()})
    want = ref.schedule_windows(rs, ref.stack_windows(rp, 1), **kw)
    np.testing.assert_array_equal(got.node_idx.numpy(), np.asarray(want.node_idx))
