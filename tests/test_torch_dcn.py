"""The port's mesh across hosts (parallel/mesh.make_mesh_multihost, the
engine's node_axes) and the learned scorer's dp x node training step
(models/learned.sharded_train_step), on the CPU with 8 shards on one
device.

Tolerances. The collectives over (dcn, node) equal the 1-D mesh's
bitwise; over one axis each group reduces in shard order, bitwise.
The 2-D engine's decisions, n_assigned, free_after, the feasibility mask
and the scores are bitwise the dense TorchEngine's and the 1-D 8-shard
mesh's; against the JAX package's 2-D program (its 8 virtual devices)
the rule of tests/test_torch_engine_affinity.py holds. The training step:
the loss within 1e-5 relative of the reference's jitted train_step on
its (2, 4) dp x node mesh, the parameters after one step within 2e-6
absolute of optax's (as tests/test_torch_two_tower.py); against the
port's dense train_step the loss within 1e-5 relative and the
parameters within 2e-6 after 1 and 5 steps; every gradient within 1e-6
of the dense gradient.

Test names and parametrize ids avoid the substrings tests/conftest.py
marks slow (sharded, multihost, auction, fused, learned, ...)."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from kubernetes_scheduler_tpu import engine as ref_engine
from kubernetes_scheduler_tpu.models import learned as R
from kubernetes_scheduler_tpu.parallel import engine as ref_par
from kubernetes_scheduler_tpu.parallel import mesh as ref_mesh
from kubernetes_scheduler_tpu.sim import gen_cluster as ref_cluster
from kubernetes_scheduler_tpu.sim import gen_pods as ref_pods
from kubernetes_scheduler_tpu_torch import TorchEngine, engine, stack_windows
from kubernetes_scheduler_tpu_torch.convert import from_reference, learned_from_reference
from kubernetes_scheduler_tpu_torch.host.snapshot import snapshot_delta
from kubernetes_scheduler_tpu_torch.models import learned as L
from kubernetes_scheduler_tpu_torch.ops import fused
from kubernetes_scheduler_tpu_torch.parallel import (
    DCN_AXIS,
    NODE_AXIS,
    Mesh,
    ShardedEngine,
    make_mesh,
    make_mesh_multihost,
    make_sharded_schedule_fn,
    make_sharded_windows_fn,
)
from kubernetes_scheduler_tpu_torch.parallel import mesh as mesh_mod
from kubernetes_scheduler_tpu_torch.parallel.mesh import DP_AXIS
from tests.test_torch_engine_affinity import _assert_batch
from tests.test_torch_mesh import (
    BACKLOG_FIELDS,
    BATCH_FIELDS,
    _cluster,
    _resident_snapshots,
    assert_bitwise,
    reference_problem,  # noqa: F401  (fixture)
)
from tests.test_torch_two_tower import PARAM_TOL, SMALL, _np_tree

BOTH = (DCN_AXIS, NODE_AXIS)
DENSE = TorchEngine(device="cpu")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-6


def _values(seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(r.astype(np.float32)) for r in rng.normal(size=(8, 3))]


def test_torch_dcn_mesh_layout():
    """make_mesh_multihost's grid, its checks, and the groups a
    reduction over some of its axes runs within."""
    mesh = make_mesh_multihost(2, 4, device="cpu")
    assert mesh.shape == (2, 4) and mesh.axis_names == BOTH and mesh.size == 8
    assert make_mesh(4, device="cpu").axis_names == (NODE_AXIS,)
    with pytest.raises(ValueError, match="devices_per_host"):
        make_mesh_multihost(2, device="cpu")
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 6, (2, 4), BOTH)
    # row-major: every axis is one group in shard order, the 1-D mesh's
    for axes in (None, BOTH, (NODE_AXIS, DCN_AXIS)):
        assert mesh.blocks(axes) == [list(range(8))], axes
    assert mesh.blocks(NODE_AXIS) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh.blocks(DCN_AXIS) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    with pytest.raises(ValueError, match="lacks axes"):
        mesh.blocks("dp")


def test_torch_dcn_collectives():
    """Over (dcn, node) every collective is bitwise the 1-D mesh's, the
    float sum in shard order; psum and pmax over node alone reduce each
    dcn row apart, over dcn each column."""
    flat, grid = make_mesh(8, device="cpu"), make_mesh_multihost(2, 4, device="cpu")
    floats = _values(2)
    for fn in (mesh_mod.psum, mesh_mod.pmax, mesh_mod.pmin, mesh_mod.all_gather):
        want = fn(floats, flat)
        assert all(torch.equal(g, w) for g, w in zip(fn(floats, grid), want)), fn.__name__
    for fn in (mesh_mod.psum, mesh_mod.pmax):
        got = fn(floats, grid, axes=BOTH)
        assert all(torch.equal(g, w) for g, w in zip(got, fn(floats, flat))), fn.__name__
    assert torch.equal(mesh_mod.psum(floats, grid)[0], functools.reduce(torch.add, floats))
    assert torch.equal(mesh_mod.gather_cat(floats, grid, dim=0), torch.cat(floats))
    assert torch.equal(mesh_mod.reduce_lead(torch.maximum, floats, grid),
                       mesh_mod.pmax(floats, flat)[0])
    for k, x in enumerate(mesh_mod.broadcast(floats[3], grid)):
        assert x is floats[3], k
    rows = [functools.reduce(torch.add, floats[r * 4:(r + 1) * 4]) for r in range(2)]
    by_row = mesh_mod.psum(floats, grid, axes=NODE_AXIS)
    by_col = mesh_mod.pmax(floats, grid, axes=DCN_AXIS)
    for k in range(8):
        assert torch.equal(by_row[k], rows[k // 4]), k
        assert torch.equal(by_col[k], torch.maximum(floats[k % 4], floats[k % 4 + 4])), k


CASES = {f"{tag}-{opt}-{r}x{c}": (a, kw, (r, c))
         for tag, a in (("scan", "greedy"), ("bid", "auction"))
         for opt, kw in (("k1", dict(normalizer="none", fused=True)),
                         ("minmax", dict(normalizer="min_max")))
         for r, c in ((2, 4), (4, 2))}


@pytest.mark.parametrize("case", list(CASES))
def test_torch_dcn_engine_matches_dense(case, monkeypatch):
    """ShardedEngine(make_mesh_multihost(r, c), node_axes=(dcn, node)):
    one window and a backlog bitwise the dense engine and the 1-D 8-shard
    mesh; K1 once per shard per window."""
    assigner, kw, shape = CASES[case]
    kw = dict(kw, assigner=assigner)
    snap, pods = _cluster("gpu", n_pods=32)
    se = ShardedEngine(make_mesh_multihost(*shape, device="cpu"), node_axes=BOTH)
    one_d = ShardedEngine(make_mesh(8, device="cpu"))
    assert se.n_shards == 8
    want = DENSE.schedule_batch(snap, pods, **kw)
    got = se.schedule_batch(snap, pods, **kw)
    assert int(want.n_assigned) > 0
    assert_bitwise(got, want, BATCH_FIELDS, case)
    assert_bitwise(got, one_d.schedule_batch(snap, pods, **kw), BATCH_FIELDS, case)
    w = stack_windows(pods, 8)
    calls = []
    original = fused.masked_score
    monkeypatch.setattr(fused, "masked_score",
                        lambda *a, **k: calls.append(1) or original(*a, **k))
    got = se.schedule_windows(snap, w, **kw)
    assert len(calls) == (4 * 8 if kw.get("fused") else 0)
    assert_bitwise(got, DENSE.schedule_windows(snap, w, **kw), BACKLOG_FIELDS, case)
    assert_bitwise(got, one_d.schedule_windows(snap, w, **kw), BACKLOG_FIELDS, case)


@pytest.mark.parametrize("axes", [NODE_AXIS, DCN_AXIS, (NODE_AXIS, DCN_AXIS)],
                         ids=["node", "dcn", "node-dcn"])
def test_torch_dcn_replicated_axes(axes):
    """node_axes naming a strict subset of the (dcn, node) mesh's axes (the
    reference's replication over the rest), or both in the other order,
    is refused: the node axis shards over every device in row-major
    order, and the full axis tuple still serves bitwise the dense
    result."""
    mesh = make_mesh_multihost(2, 4, device="cpu")
    for build in (lambda: ShardedEngine(mesh, node_axes=axes),
                  lambda: make_sharded_schedule_fn(mesh, node_axes=axes),
                  lambda: make_sharded_windows_fn(mesh, node_axes=axes)):
        with pytest.raises(ValueError, match="must name every axis"):
            build()
    snap, pods = _cluster("constraints")
    kw = dict(assigner="greedy")
    assert_bitwise(ShardedEngine(mesh, node_axes=BOTH).schedule_batch(snap, pods, **kw),
                   DENSE.schedule_batch(snap, pods, **kw), BATCH_FIELDS, str(axes))


def test_torch_dcn_missing_axes_raise():
    """node_axes naming an axis the mesh lacks raises "lacks axes", as the
    reference's _mesh_specs does."""
    flat = make_mesh(4, device="cpu")
    for build in (lambda: make_sharded_schedule_fn(flat, node_axes=BOTH),
                  lambda: make_sharded_windows_fn(flat, node_axes=BOTH),
                  lambda: ShardedEngine(flat, node_axes=BOTH),
                  lambda: ShardedEngine(make_mesh_multihost(2, 2, device="cpu"),
                                        node_axes="dp")):
        with pytest.raises(ValueError, match="lacks axes"):
            build()


@pytest.mark.parametrize("assigner", ["greedy", "auction"], ids=["scan", "bid"])
def test_torch_dcn_matches_reference_program(reference_problem, assigner):  # noqa: F811
    """The port's (2, 4) program against the JAX package's
    make_sharded_schedule_fn(make_mesh_multihost(2, 4), node_axes=(dcn,
    node)) on its 8 virtual devices (one compile each)."""
    assert jax.device_count() == 8
    rs, rp, ts, tp = reference_problem
    want = ref_par.make_sharded_schedule_fn(
        ref_mesh.make_mesh_multihost(2, 4), assigner=assigner,
        node_axes=(ref_mesh.DCN_AXIS, ref_mesh.NODE_AXIS))(rs, rp)
    got = make_sharded_schedule_fn(make_mesh_multihost(2, 4, device="cpu"), assigner=assigner,
                                   node_axes=BOTH)(ts, tp)
    assert int(got.n_assigned) > 0
    _assert_batch(got, want, rp, assigner, assigner)


def test_torch_dcn_resident_fold():
    """A full upload, then one delta folded into the 2-D mesh's 8
    per-shard states: decisions and free_after bitwise the dense
    engine's, the same delta-or-full choice, and per-shard routed bytes
    equal to the 1-D 8-shard engine's."""
    _, mksnap, pods = _resident_snapshots()
    se = ShardedEngine(make_mesh_multihost(2, 4, device="cpu"), node_axes=BOTH)
    flat = ShardedEngine(make_mesh(8, device="cpu"))
    kw = dict(assigner="auction", normalizer="none", fused=True)
    prev = None
    for epoch in (1, 2):
        snap = mksnap(300 + epoch)
        delta = snapshot_delta(prev, snap) if prev is not None else None
        got = se.schedule_resident(snap, pods, delta=delta, epoch=epoch, **kw)
        want = DENSE.schedule_batch(snap, pods, **kw)
        flat.schedule_resident(snap, pods, delta=delta, epoch=epoch, **kw)
        assert_bitwise(got, want, ("node_idx", "free_after", "n_assigned"), str(epoch))
        assert se.resident_used_delta == (epoch == 2)
        assert se.shard_delta_bytes == flat.shard_delta_bytes
        assert len(se._resident.shards) == 8
        prev = snap
    assert sum(se.shard_delta_bytes) > 0


def test_torch_dcn_two_tower_scorer():
    """make_sharded_learned_fn(node_axes=(dcn, node)) and ShardedEngine
    scored by sharded_learned_score_fn over the (2, 4) mesh, bitwise the
    dense LearnedEngine with the same parameters."""
    state, _, _ = L.init_train_state(1, model=L.NodeScorer(**SMALL), device="cpu")
    dense = L.LearnedEngine(state.params, model=L.NodeScorer(**SMALL), device="cpu")
    mesh = make_mesh_multihost(2, 4, device="cpu")
    snap, pods = _cluster("constraints", n_pods=16)
    w = stack_windows(pods, 8)
    kw = dict(assigner="auction", normalizer="min_max")
    fn = L.make_sharded_learned_fn(state.params, mesh, model=L.NodeScorer(**SMALL),
                                   node_axes=BOTH, **kw)
    assert_bitwise(fn(snap, pods), dense.schedule_batch(snap, pods, **kw),
                   ("node_idx", "free_after", "n_assigned", "feasible"))
    se = ShardedEngine(mesh, node_axes=BOTH, score_fn=L.sharded_learned_score_fn(
        state.params, mesh, model=L.NodeScorer(**SMALL)))
    assert_bitwise(se.schedule_windows(snap, w, **kw), dense.schedule_windows(snap, w, **kw),
                   BACKLOG_FIELDS)


def _train_problem():
    rs, rp = ref_cluster(32, seed=4), ref_pods(8, seed=5)
    return rs, rp, from_reference(rs, device="cpu"), from_reference(rp, device="cpu")


DP_NODE = Mesh(["cpu"] * 8, (2, 4), (DP_AXIS, NODE_AXIS))


def _port_trainer(rstate):
    state, model, tx = L.init_train_state(0, model=L.NodeScorer(**SMALL), device="cpu")
    with torch.no_grad():
        for k, v in learned_from_reference(_np_tree(rstate.params)).items():
            state.params[k].copy_(v)
    return state, model, tx


def test_torch_dcn_train_step_matches_reference():
    """sharded_train_step on the (2, 4) dp x node CPU mesh against the
    reference's train_step jitted over its ("dp", "node") mesh of 8
    virtual devices, inputs placed as the reference's test places them,
    from the same parameters (one compile)."""
    assert jax.device_count() == 8
    rs, rp, ts, tp = _train_problem()
    model = R.NodeScorer(**SMALL)
    rstate, _, rtx = R.init_train_state(jax.random.key(2), model=model)
    pstate, pmodel, ptx = _port_trainer(rstate)
    rx = R.make_features(rs, rp)
    teacher = ref_engine.compute_scores(rs, rp, "balanced_cpu_diskio")
    jmesh = JaxMesh(np.asarray(jax.devices()).reshape(2, 4), ("dp", "node"))
    put = lambda x, *spec: jax.device_put(x, NamedSharding(jmesh, P(*spec)))  # noqa: E731
    step = jax.jit(functools.partial(R.train_step, model=model, tx=rtx))
    with jmesh:
        rstate, rloss = step(
            jax.device_put(rstate, NamedSharding(jmesh, P())),
            pod_x=put(rx[0], "dp", None), node_x=put(rx[1], "node", None),
            teacher_scores=put(teacher, "dp", "node"), node_mask=put(rs.node_mask, "node"),
            pod_mask=put(rp.pod_mask, "dp"))
    pstate, ploss = L.sharded_train_step(
        pstate, pmodel, ptx, DP_NODE, *L.make_features(ts, tp),
        torch.from_numpy(np.array(teacher)), ts.node_mask, tp.pod_mask)
    assert pstate.step == 1
    assert float(ploss) == pytest.approx(float(rloss), rel=LOSS_RTOL)
    for k, v in learned_from_reference(_np_tree(rstate.params)).items():
        np.testing.assert_allclose(pstate.params[k].detach().numpy(), v.numpy(),
                                   rtol=0, atol=PARAM_TOL, err_msg=k)


def test_torch_dcn_train_step_matches_dense():
    """sharded_train_step against the port's dense train_step from the
    same parameters: the loss and every parameter's gradient (the sum of
    the 8 blocks' contributions, each a fraction of the whole) before the
    first step, the parameters after 1 and 5 steps."""
    rs, rp, ts, tp = _train_problem()
    rstate, _, _ = R.init_train_state(jax.random.key(3), model=R.NodeScorer(**SMALL))
    (dstate, dmodel, dtx), (sstate, smodel, stx) = _port_trainer(rstate), _port_trainer(rstate)
    px, nx = L.make_features(ts, tp)
    teacher = engine.compute_scores(ts, tp, "balanced_cpu_diskio")
    args = (px, nx, teacher, ts.node_mask, tp.pod_mask)
    dense_loss = L.imitation_loss(dmodel, dstate.params, *args)
    mesh_loss = L.sharded_imitation_loss(smodel, sstate.params, DP_NODE, *args)
    assert float(mesh_loss.detach()) == pytest.approx(float(dense_loss.detach()), rel=LOSS_RTOL)
    dense_grads = torch.autograd.grad(dense_loss, list(dstate.params.values()))
    mesh_grads = torch.autograd.grad(mesh_loss, list(sstate.params.values()))
    for name, g, h in zip(dstate.params, dense_grads, mesh_grads):
        np.testing.assert_allclose(h.numpy(), g.numpy(), rtol=0, atol=GRAD_TOL, err_msg=name)
    for i in range(1, 6):
        dstate, dloss = L.train_step(dstate, dmodel, dtx, *args)
        sstate, sloss = L.sharded_train_step(sstate, smodel, stx, DP_NODE, *args)
        assert sstate.step == dstate.step == i
        if i in (1, 5):
            assert float(sloss) == pytest.approx(float(dloss), rel=LOSS_RTOL), i
            for k in dstate.params:
                np.testing.assert_allclose(sstate.params[k].detach().numpy(),
                                           dstate.params[k].detach().numpy(), rtol=0,
                                           atol=PARAM_TOL, err_msg=f"{k} step {i}")
    with pytest.raises(ValueError, match="does not split"):
        L.sharded_train_step(sstate, smodel, stx, Mesh(["cpu"] * 3, (1, 3), (DP_AXIS, NODE_AXIS)),
                             *args)
    with pytest.raises(ValueError, match="a training mesh has axes"):
        L.sharded_train_step(sstate, smodel, stx, make_mesh_multihost(2, 4, device="cpu"), *args)
