"""The port's slice (kubernetes_scheduler_tpu_torch.engine) against the
JAX reference: the fused auction cycle and the multi-window backlog scan
give the same pod -> node decisions, the same assigned count, and a
bitwise-equal free capacity, on generated clusters."""

import numpy as np
import pytest
import torch

from kubernetes_scheduler_tpu import engine as ref
from kubernetes_scheduler_tpu.sim import gen_cluster as ref_cluster
from kubernetes_scheduler_tpu.sim import gen_pods as ref_pods
from kubernetes_scheduler_tpu.utils import padding as ref_padding
from kubernetes_scheduler_tpu_torch import TorchEngine, engine
from kubernetes_scheduler_tpu_torch.convert import from_reference
from kubernetes_scheduler_tpu_torch.sim import gen_cluster, gen_pods
from kubernetes_scheduler_tpu_torch.utils.padding import pad_pod_batch

KW = dict(assigner="auction", normalizer="min_max", fused=True, affinity_aware=False)
FEATURES = {"gpu": {"gpu": True}, "constraints": {"constraints": True}}


def _problem(features, n_nodes=300, n_pods=96):
    feats = FEATURES[features]
    return (
        ref_cluster(n_nodes, seed=3, **feats), ref_pods(n_pods, seed=4, **feats),
        gen_cluster(n_nodes, seed=3, device="cpu", **feats),
        gen_pods(n_pods, seed=4, device="cpu", **feats),
    )


def _assert_same(got, want):
    np.testing.assert_array_equal(got.node_idx.numpy(), np.asarray(want.node_idx))
    assert int(got.n_assigned) == int(want.n_assigned)
    np.testing.assert_array_equal(
        got.free_after.numpy().view(np.uint32),
        np.asarray(want.free_after).view(np.uint32),
    )


@pytest.mark.parametrize("features", sorted(FEATURES))
def test_torch_schedule_batch_matches_reference(features):
    rs, rp, ts, tp = _problem(features)
    want = ref.schedule_batch(rs, rp, **KW)
    got = TorchEngine(device="cpu").schedule_batch(ts, tp, **KW)
    _assert_same(got, want)
    assert int(got.n_assigned) > 0
    np.testing.assert_array_equal(
        got.feasible.numpy(), np.asarray(want.feasible)
    )


@pytest.mark.parametrize("features", sorted(FEATURES))
def test_torch_backlog_scan_matches_reference(features):
    rs, rp, ts, tp = _problem(features)
    want = ref.schedule_windows(rs, ref.stack_windows(rp, 32), **KW)
    got = TorchEngine(device="cpu").schedule_windows(ts, engine.stack_windows(tp, 32), **KW)
    assert tuple(got.node_idx.shape) == (3, 32)
    _assert_same(got, want)


def test_torch_backlog_padding_and_gangs_match_reference():
    """A backlog padded to whole windows, with one gang that fits and one
    that cannot (a member pinned to a missing node), and contended
    capacity, through the numpy leaves a host would hand in."""
    rs = ref_cluster(40, seed=8)
    rp = ref_pods(70, seed=9)
    gang_id = np.full(70, -1, np.int32)
    gang_size = np.zeros(70, np.int32)
    gang_id[:4], gang_size[:4] = 0, 4
    gang_id[10:13], gang_size[10:13] = 1, 3
    target = np.full(70, -1, np.int32)
    target[11] = 999
    rp = rp._replace(gang_id=gang_id, gang_size=gang_size, target_node=target)
    padded = ref_padding.pad_pod_batch(rp, 96)
    want = ref.schedule_windows(rs, ref.stack_windows(padded, 32), **KW)
    np_pods = type(rp)(*[np.asarray(f) for f in rp])
    got_pad = pad_pod_batch(np_pods, 96)
    for a, b in zip(got_pad, padded):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    t_pad = pad_pod_batch(from_reference(rp, device="cpu"), 96)
    for a, b in zip(t_pad, padded):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = TorchEngine(device="cpu").schedule_windows(
        type(rs)(*[np.asarray(f) for f in rs]),
        engine.stack_windows(got_pad, 32), **KW,
    )
    _assert_same(got, want)
    assert (got.node_idx.numpy()[0, 10:13] < 0).all()   # the gang that cannot fit
    assert (got.node_idx.numpy()[0, :4] >= 0).all()
    assert (got.node_idx.numpy()[2, 6:] == -1).all()     # padding rows


@pytest.mark.parametrize("features", sorted(FEATURES))
def test_torch_generator_matches_reference(features):
    rs, rp, ts, tp = _problem(features, n_nodes=64, n_pods=24)
    for ref_nt, port_nt in ((rs, ts), (rp, tp)):
        carried = from_reference(ref_nt, device="cpu")
        assert type(carried) is type(port_nt)
        for name, a, b, c in zip(ref_nt._fields, ref_nt, port_nt, carried):
            a = np.asarray(a)
            assert b.numpy().dtype == a.dtype, name
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
            np.testing.assert_array_equal(c.numpy(), a, err_msg=name)


@pytest.mark.parametrize(
    "kw,error,match",
    [(dict(KW, normalizer="softmax"), ValueError, "normalizer"),
     (dict(KW, score_plugins=(("least_allocated", 1.0),)), ValueError, "score_plugins")],
    ids=["softmax-kernel", "plugins-kernel"],
)
def test_torch_unported_options_raise(kw, error, match):
    """Every option of schedule_batch is ported (preemption is the next
    test's); softmax and score plugins are refused on the kernel path, as
    the reference refuses them."""
    _, _, ts, tp = _problem("gpu", n_nodes=16, n_pods=8)
    with pytest.raises(error, match=match):
        engine.schedule_batch(ts, tp, **kw)


def test_torch_engine_eviction_not_ported():
    """TorchEngine.preempt, once the one engine call left to port (ROADMAP
    queue A, item 6), now runs the pass and equals the reference's
    preempt_batch on the same cluster (tests/test_torch_preemption.py
    holds it in full). (The name avoids the substring that
    tests/conftest.py marks slow.)"""
    import jax.numpy as jnp

    from kubernetes_scheduler_tpu.ops.preempt import VictimArrays as RefVictims
    from kubernetes_scheduler_tpu_torch.ops.preempt import VictimArrays

    rs, rp, ts, tp = _problem("gpu", n_nodes=16, n_pods=8)
    rs, ts = rs._replace(requested=rs.allocatable), ts._replace(requested=ts.allocatable)
    rng = np.random.default_rng(0)
    v = dict(node=rng.integers(0, 16, 32).astype(np.int32),
             prio=rng.integers(-5, 5, 32).astype(np.int32),
             req=np.asarray(rp.request)[rng.integers(0, 8, 32)],
             mask=np.ones(32, bool), start=rng.integers(0, 99, 32).astype(np.int32))
    want = ref.preempt_batch(rs, rp, RefVictims(**{k: jnp.asarray(x) for k, x in v.items()}),
                             k_cap=4)
    got = TorchEngine(device="cpu").preempt(ts, tp, VictimArrays(**v), k_cap=4)
    for name in ("node", "victims", "n_victims"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert (got.node.numpy() >= 0).any()


def test_torch_plain_flag_matches_default_on_cpu():
    _, _, ts, tp = _problem("gpu", n_nodes=64, n_pods=32)
    a = engine.schedule_batch(ts, tp, **KW)
    b = engine.schedule_batch(ts, tp, **KW, _plain=True)
    assert torch.equal(a.node_idx, b.node_idx) and torch.equal(a.free_after, b.free_after)
