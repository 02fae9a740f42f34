"""The port's two-tower scorer (kubernetes_scheduler_tpu_torch/models/learned.py)
against the JAX package's flax model, optax optimizer and LearnedEngine,
on the CPU, from the same seeded inputs, the reference's parameters
carried across by convert.learned_from_reference.

Tolerances. Features are bitwise. The forward differs by float32
rounding of the products (at most 1.2e-7 measured at both widths):
scores within 1e-6 absolute. Training: imitation_loss within 1e-6
relative, the loss after 1 and 5 AdamW steps within 1e-5 relative and
every parameter within 2e-6 absolute of optax's (3.3e-7 measured).
Engine decisions, masks and free_after are equal (greedy may flip at a
near tie, by the rule of tests/test_torch_engine_affinity.py), scores
within 1e-4 absolute after min-max (raw error x 100 / row range).

Test names and parametrize ids avoid the substrings tests/conftest.py
marks slow (learned, checkpoint, auction, windows, ...)."""

import functools

import jax
import numpy as np
import pytest
import torch

from kubernetes_scheduler_tpu import engine as ref_engine
from kubernetes_scheduler_tpu.models import learned as R
from kubernetes_scheduler_tpu.sim import gen_cluster as ref_cluster
from kubernetes_scheduler_tpu.sim import gen_pods as ref_pods
from kubernetes_scheduler_tpu_torch import engine, stack_windows
from kubernetes_scheduler_tpu_torch.convert import from_reference, learned_from_reference
from kubernetes_scheduler_tpu_torch.models import learned as L
from tests.test_torch_engine_affinity import _assert_batch

SMALL = dict(d_model=16, width=32, depth=2)
FORWARD_TOL = 1e-6
PARAM_TOL = 2e-6
SCORE_TOL = 1e-4


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _problem(n_nodes=40, n_pods=16, seed=1, constraints=False):
    rs = ref_cluster(n_nodes, seed=seed, gpu=True, constraints=constraints)
    rp = ref_pods(n_pods, seed=seed + 1, gpu=True, constraints=constraints)
    return rs, rp, from_reference(rs, device="cpu"), from_reference(rp, device="cpu")


@pytest.fixture(scope="module")
def trained():
    """A small reference model after 5 optax steps (scores that are not
    the init's), its flax params as numpy, and the port's state dict."""
    model = R.NodeScorer(**SMALL)
    state, _, tx = R.init_train_state(jax.random.key(0), model=model)
    rs, rp, _, _ = _problem(seed=7)
    px, nx = R.make_features(rs, rp)
    teacher = ref_engine.compute_scores(rs, rp, "balanced_cpu_diskio")
    step = jax.jit(functools.partial(R.train_step, model=model, tx=tx))
    for _ in range(5):
        state, _ = step(state, pod_x=px, node_x=nx, teacher_scores=teacher,
                        node_mask=rs.node_mask, pod_mask=rp.pod_mask)
    flax_params = _np_tree(state.params)
    return model, flax_params, learned_from_reference(flax_params)


@pytest.mark.parametrize("constraints", [False, True], ids=["gpu", "constraints"])
def test_torch_two_tower_features_match_reference(constraints):
    rs, rp, ts, tp = _problem(constraints=constraints)
    want = R.make_features(rs, rp)
    got = L.make_features(ts, tp)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("widths", [SMALL, {}], ids=["small", "default"])
def test_torch_two_tower_forward_matches_flax(widths):
    model = R.NodeScorer(**widths)
    state, _, _ = R.init_train_state(jax.random.key(3), model=model)
    rs, rp, ts, tp = _problem(seed=5)
    want = np.asarray(model.apply(state.params, *R.make_features(rs, rp)))
    port = L.NodeScorer(**widths)
    assert (port.d_model, port.width, port.depth) == (model.d_model, model.width, model.depth)
    sd = learned_from_reference(_np_tree(state.params))
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(*L.make_features(ts, tp))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FORWARD_TOL)


def test_torch_two_tower_parameter_names_map_one_to_one():
    port = L.NodeScorer()
    want = [f"{tower}.Dense_{i}.{leaf}" for tower in ("pod_tower", "node_tower")
            for i in range(3) for leaf in ("weight", "bias")]
    assert sorted(port.state_dict()) == sorted(want + ["node_bias.weight", "node_bias.bias"])
    assert tuple(port.pod_tower.Dense_0.weight.shape) == (256, L.POD_FEATURES)
    assert tuple(port.node_tower.Dense_2.weight.shape) == (128, 256)
    assert tuple(port.node_bias.weight.shape) == (1, L.NODE_FEATURES)


def test_torch_two_tower_init_distribution():
    """flax's lecun_normal: a normal truncated at +-2 sigma, sigma =
    sqrt(1 / fan_in) / 0.8796 (so the kept draws have std sqrt(1 /
    fan_in)), zero biases; seeded, so two inits from one seed are equal."""
    a, model, tx = L.init_train_state(11, device="cpu")
    b, _, _ = L.init_train_state(11, device="cpu")
    for name, t in a.params.items():
        t = t.detach()
        assert torch.equal(t, b.params[name].detach()), name
        if name.endswith("bias"):
            assert not t.any(), name
            continue
        fan_in = t.shape[1]
        sigma = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        assert float(t.abs().max()) <= 2 * sigma + 1e-7, name
    w = a.params["pod_tower.Dense_1.weight"].detach()
    assert abs(float(w.std()) - (1.0 / 256) ** 0.5) < 0.05 * (1.0 / 256) ** 0.5
    group = tx.param_groups[0]
    assert group["weight_decay"] == 1e-4 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8 and group["lr"] == 1e-3


def _ref_and_port_trainers(seed=0):
    model = R.NodeScorer(**SMALL)
    rstate, _, rtx = R.init_train_state(jax.random.key(seed), model=model)
    pstate, pmodel, ptx = L.init_train_state(0, model=L.NodeScorer(**SMALL), device="cpu")
    with torch.no_grad():
        for k, v in learned_from_reference(_np_tree(rstate.params)).items():
            pstate.params[k].copy_(v)
    return (model, rstate, rtx), (pmodel, pstate, ptx)


def test_torch_two_tower_loss_and_steps_match_optax():
    (rmodel, rstate, rtx), (pmodel, pstate, ptx) = _ref_and_port_trainers()
    rs, rp, ts, tp = _problem(seed=9)
    rx = R.make_features(rs, rp)
    px = L.make_features(ts, tp)
    teacher = ref_engine.compute_scores(rs, rp, "balanced_cpu_diskio")
    tt = torch.from_numpy(np.array(teacher))
    want0 = float(R.imitation_loss(rmodel, rstate.params, *rx, teacher, rs.node_mask,
                                   rp.pod_mask))
    got0 = float(L.imitation_loss(pmodel, pstate.params, *px, tt, ts.node_mask,
                                  tp.pod_mask).detach())
    assert got0 == pytest.approx(want0, rel=1e-6)
    step = jax.jit(functools.partial(R.train_step, model=rmodel, tx=rtx))
    for i in range(1, 6):
        rstate, rloss = step(rstate, pod_x=rx[0], node_x=rx[1], teacher_scores=teacher,
                             node_mask=rs.node_mask, pod_mask=rp.pod_mask)
        pstate, ploss = L.train_step(pstate, pmodel, ptx, *px, tt, ts.node_mask, tp.pod_mask)
        assert pstate.step == i
        if i in (1, 5):
            assert float(ploss) == pytest.approx(float(rloss), rel=1e-5), i
            want = learned_from_reference(_np_tree(rstate.params))
            for k, v in want.items():
                np.testing.assert_allclose(pstate.params[k].detach().numpy(), v.numpy(),
                                           rtol=0, atol=PARAM_TOL, err_msg=f"{k} step {i}")


def test_torch_two_tower_loss_falls():
    """50 steps against balanced_cpu_diskio's raw scores: the loss falls
    by more than 10%, as the reference's distillation test asks."""
    state, model, tx = L.init_train_state(0, model=L.NodeScorer(**SMALL), device="cpu")
    _, _, ts, tp = _problem(n_nodes=32, n_pods=8, seed=0)
    px = L.make_features(ts, tp)
    teacher = engine.compute_scores(ts, tp, "balanced_cpu_diskio")
    losses = []
    for _ in range(50):
        state, loss = L.train_step(state, model, tx, *px, teacher, ts.node_mask, tp.pod_mask)
        losses.append(float(loss))
    assert losses[-1] < 0.9 * losses[0], losses[:3] + losses[-3:]


def test_torch_two_tower_state_round_trip(tmp_path):
    """save_checkpoint / restore_checkpoint: params bitwise, the step, and
    the optimizer state, so a restored trainer's next step equals the
    original's bitwise."""
    state, model, tx = L.init_train_state(2, model=L.NodeScorer(**SMALL), device="cpu")
    _, _, ts, tp = _problem(n_nodes=24, n_pods=6, seed=4)
    px = L.make_features(ts, tp)
    teacher = engine.compute_scores(ts, tp, "balanced_cpu_diskio")
    for _ in range(3):
        state, _ = L.train_step(state, model, tx, *px, teacher, ts.node_mask, tp.pod_mask)
    path = str(tmp_path / "state")
    L.save_checkpoint(path, state)
    L.save_checkpoint(path, state)          # over an existing one: replaced whole
    like, model2, tx2 = L.init_train_state(5, model=L.NodeScorer(**SMALL), device="cpu")
    restored = L.restore_checkpoint(path, like)
    assert restored.step == 3
    for k, v in state.params.items():
        assert torch.equal(restored.params[k], v), k
    eng = L.load_learned_engine(path, model=L.NodeScorer(**SMALL), device="cpu")
    for k, v in state.params.items():
        assert torch.equal(eng.params[k], v), k
    tx2.load_state_dict(restored.opt_state)
    a, _ = L.train_step(state, model, tx, *px, teacher, ts.node_mask, tp.pod_mask)
    b, _ = L.train_step(restored, model2, tx2, *px, teacher, ts.node_mask, tp.pod_mask)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


def test_torch_two_tower_orbax_state_served(tmp_path):
    """A state the reference saved with orbax, restored by the reference,
    converted and served by the port: the same decisions as the
    reference's LearnedEngine on that state."""
    model = R.NodeScorer(**SMALL)
    state, _, tx = R.init_train_state(jax.random.key(4), model=model)
    rs, rp, ts, tp = _problem(seed=11)
    px, nx = R.make_features(rs, rp)
    teacher = ref_engine.compute_scores(rs, rp, "balanced_cpu_diskio")
    for _ in range(2):
        state, _ = R.train_step(state, model, tx, px, nx, teacher, rs.node_mask, rp.pod_mask)
    path = str(tmp_path / "orbax")
    R.save_checkpoint(path, state)
    like, _, _ = R.init_train_state(jax.random.key(0), model=model)
    restored = R.restore_checkpoint(path, like)
    port = L.LearnedEngine(learned_from_reference(_np_tree(restored.params)),
                           model=L.NodeScorer(**SMALL), device="cpu")
    kw = dict(assigner="auction", normalizer="min_max", affinity_aware=False)
    want = R.LearnedEngine(restored.params, model=model).schedule_batch(rs, rp, **kw)
    got = port.schedule_batch(ts, tp, **kw)
    np.testing.assert_allclose(got.raw_scores.numpy(), np.asarray(want.raw_scores),
                               rtol=0, atol=FORWARD_TOL)
    _assert_batch(got, want, rp, "auction", "orbax")


ENGINE_CASES = {
    "scan-live": dict(assigner="greedy", affinity_aware=True),
    "scan-static": dict(assigner="greedy", affinity_aware=False),
    "bid-live": dict(assigner="auction", affinity_aware=True),
    "bid-static": dict(assigner="auction", affinity_aware=False),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_torch_two_tower_engine_matches_reference(trained, case):
    model, flax_params, sd = trained
    kw = dict(ENGINE_CASES[case], normalizer="min_max")
    rs, rp, ts, tp = _problem(n_nodes=64, n_pods=24, seed=13, constraints=True)
    want = R.LearnedEngine(flax_params, model=model).schedule_batch(rs, rp, **kw)
    got = L.LearnedEngine(sd, model=L.NodeScorer(**SMALL), device="cpu").schedule_batch(
        ts, tp, **kw)
    assert int(got.n_assigned) > 0
    np.testing.assert_allclose(got.raw_scores.numpy(), np.asarray(want.raw_scores),
                               rtol=0, atol=FORWARD_TOL)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=SCORE_TOL)
    _assert_batch(got, want, rp, kw["assigner"], case)


@pytest.mark.parametrize("assigner", ["greedy", "auction"], ids=["scan", "bid"])
def test_torch_two_tower_backlog_matches_reference(trained, assigner):
    model, flax_params, sd = trained
    kw = dict(assigner=assigner, normalizer="min_max")
    rs, rp, ts, tp = _problem(n_nodes=48, n_pods=32, seed=17, constraints=True)
    want = R.LearnedEngine(flax_params, model=model).schedule_windows(
        rs, ref_engine.stack_windows(rp, 8), **kw)
    got = L.LearnedEngine(sd, model=L.NodeScorer(**SMALL), device="cpu").schedule_windows(
        ts, stack_windows(tp, 8), **kw)
    assert tuple(got.node_idx.shape) == (4, 8) and int(got.n_assigned) > 0
    np.testing.assert_array_equal(got.node_idx.numpy(), np.asarray(want.node_idx))
    assert int(got.n_assigned) == int(want.n_assigned)
    np.testing.assert_array_equal(got.free_after.numpy().view(np.uint32),
                                  np.asarray(want.free_after).view(np.uint32))


def test_torch_two_tower_engine_takes_the_kernels_wrappers(trained):
    """With affinity_aware=False the learned engine's greedy runs the K4
    wrapper and its auction the K3 wrapper (their plain versions on the
    CPU); _plain=True gives the same result."""
    from kubernetes_scheduler_tpu_torch.ops import fused

    _, _, sd = trained
    eng = L.LearnedEngine(sd, model=L.NodeScorer(**SMALL), device="cpu")
    _, _, ts, tp = _problem(n_nodes=32, n_pods=12, seed=19)
    calls = {"auction_bid": 0, "greedy_scan": 0}
    originals = {name: getattr(fused, name) for name in calls}

    def counting(name):
        def wrapper(*a, **k):
            calls[name] += 1
            return originals[name](*a, **k)
        return wrapper

    try:
        for name in calls:
            setattr(fused, name, counting(name))
        for assigner in ("greedy", "auction"):
            kw = dict(assigner=assigner, affinity_aware=False)
            a = eng.schedule_batch(ts, tp, **kw)
            b = eng.schedule_batch(ts, tp, _plain=True, **kw)
            assert torch.equal(a.node_idx, b.node_idx)
            assert torch.equal(a.free_after, b.free_after)
    finally:
        for name, fn in originals.items():
            setattr(fused, name, fn)
    assert calls["greedy_scan"] == 2 and calls["auction_bid"] >= 2


def test_torch_two_tower_scheduler_route(trained, monkeypatch):
    """The port's Scheduler with policy="learned" on the port's
    LearnedEngine binds the pods the reference's Scheduler binds on the
    reference's LearnedEngine with the same parameters, in the same order."""
    from kubernetes_scheduler_tpu.host import scheduler as ref_sched
    from kubernetes_scheduler_tpu.host import types as ref_types
    from kubernetes_scheduler_tpu.sim import host_gen as ref_gen
    from kubernetes_scheduler_tpu.utils import config as ref_config
    from kubernetes_scheduler_tpu_torch.host import scheduler as port_sched
    from kubernetes_scheduler_tpu_torch.host import types as port_types
    from kubernetes_scheduler_tpu_torch.sim import host_gen as port_gen
    from kubernetes_scheduler_tpu_torch.utils import config as port_config
    from tests import test_torch_host as host

    model, flax_params, sd = trained
    monkeypatch.setitem(host.SIDES, "ref-tower", (
        ref_sched, ref_gen, ref_config, ref_types,
        lambda: R.LearnedEngine(flax_params, model=model)))
    monkeypatch.setitem(host.SIDES, "port-tower", (
        port_sched, port_gen, port_config, port_types,
        lambda: L.LearnedEngine(sd, model=L.NodeScorer(**SMALL), device="cpu")))
    cfg = dict(host.DEVICE, policy="learned")
    want, _, ref = host.drain("ref-tower", cfg, n_pods=48)
    got, _, port = host.drain("port-tower", cfg, n_pods=48)
    assert len(got) > 48 and got == want
    assert port.totals["fallback_cycles"] == ref.totals["fallback_cycles"] == 0
    with pytest.raises(ValueError, match="requires a LearnedEngine"):
        port_sched.Scheduler(
            port_config.SchedulerConfig(policy="learned"), advisor=None,
            list_nodes=list, list_running_pods=list,
            engine=engine.TorchEngine(device="cpu"),
        )


def test_torch_two_tower_server_route(tmp_path):
    """`--learned-checkpoint` on --device cpu: the sidecar serves the
    restored LearnedEngine, and its replies over the wire (one window and
    a backlog) are bitwise the in-process engine's."""
    from kubernetes_scheduler_tpu_torch.bridge import RemoteEngine
    from kubernetes_scheduler_tpu_torch.bridge import server as server_mod
    from kubernetes_scheduler_tpu_torch.sim import gen_cluster, gen_pods

    state, _, _ = L.init_train_state(6, device="cpu")
    path = str(tmp_path / "state")
    L.save_checkpoint(path, state)
    args = server_mod.build_parser().parse_args(
        ["--device", "cpu", "--port", "0", "--host", "127.0.0.1",
         "--learned-checkpoint", path])
    server, port, service = server_mod.server_from_args(args)
    server.start()
    client = RemoteEngine(f"127.0.0.1:{port}", deadline_seconds=120.0)
    try:
        assert isinstance(service._engine, L.LearnedEngine)
        local = L.load_learned_engine(path, device="cpu")
        snap = gen_cluster(48, seed=2, device="cpu")
        pods = gen_pods(16, seed=3, device="cpu")
        for assigner in ("greedy", "auction"):
            kw = dict(policy="learned", assigner=assigner, normalizer="min_max")
            got = client.schedule_batch(snap, pods, **kw)
            want = local.schedule_batch(snap, pods, **kw)
            for name in ("node_idx", "free_after", "n_assigned", "scores"):
                np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                              getattr(want, name).numpy(), err_msg=name)
        w = stack_windows(pods, 8)
        kw = dict(assigner="auction", normalizer="min_max")
        got = client.schedule_windows(snap, w, policy="learned", **kw)
        want = local.schedule_windows(snap, w, **kw)
        np.testing.assert_array_equal(np.asarray(got.node_idx), want.node_idx.numpy())
        np.testing.assert_array_equal(np.asarray(got.free_after), want.free_after.numpy())
    finally:
        client.close()
        server.stop(None)
