"""The port's node-sharded engine (kubernetes_scheduler_tpu_torch/parallel/)
on the CPU, with 4 and 8 shards on one device (a repeated-device mesh,
the counterpart of the reference's 8 virtual CPU devices).

Tolerance: none against the port's dense engine. Decisions, n_assigned,
free_after, the feasibility mask and the scores are bitwise TorchEngine's
(device="cpu") for every option: both assigners, min-max, softmax and no
normalizer, K1 per shard, soft terms, score plugins, every policy, pinned
pods, affinity, backlogs, resident delta folds and the learned scorer.
Against the JAX package's sharded programs (its 8 virtual devices) the
rule of tests/test_torch_engine_affinity.py holds (decisions equal, or a
near-tie greedy flip), and the per-shard delta bytes are equal.

Test names and parametrize ids avoid the substrings tests/conftest.py
marks slow (sharded, auction, windows, fused, learned, ...)."""

import jax
import numpy as np
import pytest
import torch

from kubernetes_scheduler_tpu import engine as ref_engine
from kubernetes_scheduler_tpu.host import snapshot as ref_snap
from kubernetes_scheduler_tpu.parallel import engine as ref_par
from kubernetes_scheduler_tpu.parallel import mesh as ref_mesh
from kubernetes_scheduler_tpu.sim import gen_cluster as ref_cluster
from kubernetes_scheduler_tpu.sim import gen_pods as ref_pods
from kubernetes_scheduler_tpu_torch import TorchEngine, make_pod_batch, make_snapshot, stack_windows
from kubernetes_scheduler_tpu_torch.convert import from_reference
from kubernetes_scheduler_tpu_torch.host.snapshot import shard_snapshot_delta, snapshot_delta
from kubernetes_scheduler_tpu_torch.models import learned as L
from kubernetes_scheduler_tpu_torch.ops import fused
from kubernetes_scheduler_tpu_torch.parallel import (
    Mesh,
    ShardedEngine,
    make_mesh,
    make_sharded_schedule_fn,
    make_sharded_windows_fn,
    stack_shard_deltas,
)
from kubernetes_scheduler_tpu_torch.parallel import mesh as mesh_mod
from kubernetes_scheduler_tpu_torch.sim import gen_cluster, gen_pods
from tests.test_torch_engine_affinity import _assert_batch

DENSE = TorchEngine(device="cpu")
PLUGINS = (("balanced_cpu_diskio", 2.0), ("least_allocated", 1.0), ("balanced_diskio", 0.5))


def _cluster(kind: str, n_nodes=64, n_pods=24, seed=3):
    feats = {"gpu": dict(gpu=True), "constraints": dict(constraints=True),
             "images": dict(images=True)}[kind]
    return (gen_cluster(n_nodes, seed=seed, device="cpu", **feats),
            gen_pods(n_pods, seed=seed + 1, device="cpu", **feats))


def _pinned(pods):
    """Pods 0, 5, 11 pinned to nodes in three shards, pod 7 to a node that
    does not exist (matches nothing)."""
    target = pods.target_node.clone()
    target[0], target[5], target[11], target[7] = 3, 37, 62, 64
    return pods._replace(target_node=target)


def assert_bitwise(got, want, fields, what=""):
    for name in fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        if g.dtype.is_floating_point:
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), (what, name)
        else:
            assert torch.equal(g, w), (what, name)


BATCH_FIELDS = ("node_idx", "free_after", "n_assigned", "feasible", "scores", "raw_scores")
BACKLOG_FIELDS = ("node_idx", "free_after", "n_assigned")

CASES = {}
for _a, _tag in (("greedy", "scan"), ("auction", "bid")):
    CASES[f"{_tag}-minmax"] = ("gpu", dict(assigner=_a))
    CASES[f"{_tag}-softmax"] = ("gpu", dict(assigner=_a, normalizer="softmax"))
    CASES[f"{_tag}-raw"] = ("gpu", dict(assigner=_a, normalizer="none"))
    CASES[f"{_tag}-k1"] = ("gpu", dict(assigner=_a, normalizer="none", fused=True))
    CASES[f"{_tag}-soft"] = ("constraints", dict(assigner=_a, soft=True))
    CASES[f"{_tag}-plugins"] = ("gpu", dict(assigner=_a, score_plugins=PLUGINS))
    CASES[f"{_tag}-pinned"] = ("gpu", dict(assigner=_a, pinned=True))
    CASES[f"{_tag}-affinity"] = ("constraints", dict(assigner=_a))
    CASES[f"{_tag}-affinity-k1"] = ("constraints", dict(assigner=_a, normalizer="none",
                                                        fused=True))
for _p in ("balanced_diskio", "free_capacity", "card", "least_allocated",
           "balanced_allocation"):
    CASES[f"policy-{_p}"] = ("gpu", dict(assigner="greedy", policy=_p))
CASES["policy-image_locality"] = ("images", dict(assigner="greedy", policy="image_locality"))


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_torch_mesh_matches_dense(case, shards):
    kind, kw = CASES[case]
    kw = dict(kw)
    snap, pods = _cluster(kind)
    if kw.pop("pinned", False):
        pods = _pinned(pods)
    want = DENSE.schedule_batch(snap, pods, **kw)
    got = ShardedEngine(make_mesh(shards, device="cpu")).schedule_batch(snap, pods, **kw)
    assert int(want.n_assigned) > 0
    assert_bitwise(got, want, BATCH_FIELDS, case)


BACKLOG_CASES = {
    "scan": ("gpu", dict(assigner="greedy", normalizer="min_max")),
    "bid": ("gpu", dict(assigner="auction")),
    "bid-k1": ("gpu", dict(assigner="auction", normalizer="none", fused=True)),
    "scan-soft": ("constraints", dict(assigner="greedy", normalizer="min_max", soft=True)),
    "scan-affinity": ("constraints", dict(assigner="greedy", normalizer="min_max")),
    "bid-affinity": ("constraints", dict(assigner="auction")),
    "bid-plugins": ("gpu", dict(assigner="auction", score_plugins=PLUGINS)),
}


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("case", list(BACKLOG_CASES))
def test_torch_mesh_backlog_matches_dense(case, shards):
    kind, kw = BACKLOG_CASES[case]
    snap, pods = _cluster(kind, n_pods=32)
    w = stack_windows(pods, 8)
    want = DENSE.schedule_windows(snap, w, **kw)
    got = ShardedEngine(make_mesh(shards, device="cpu")).schedule_windows(snap, w, **kw)
    assert int(want.n_assigned) > 0
    assert_bitwise(got, want, BACKLOG_FIELDS, case)


def test_torch_mesh_factories_take_options_and_knobs():
    """The factories' own surface: per-call auction knobs override the
    build-time defaults (each bitwise the dense call with those knobs),
    a rounds value beyond int32 means "to convergence", and the options
    the reference refuses are refused."""
    mesh = make_mesh(4, device="cpu")
    snap, pods = _cluster("gpu")
    fn = make_sharded_schedule_fn(mesh, assigner="auction", auction_price_frac=1.0)
    for knobs in ({}, {"auction_price_frac": 0.25}, {"auction_rounds": 3},
                  {"auction_rounds": 2**40}):
        want = DENSE.schedule_batch(snap, pods, assigner="auction", **knobs)
        assert_bitwise(fn(snap, pods, **knobs), want, BATCH_FIELDS, str(knobs))
    for bad in (dict(assigner="nope"), dict(fused=True), dict(fused=True, policy="card",
                normalizer="none"), dict(score_plugins=PLUGINS, fused=True,
                normalizer="none")):
        with pytest.raises(ValueError):
            make_sharded_schedule_fn(mesh, **bad)
        with pytest.raises(ValueError):
            make_sharded_windows_fn(mesh, **bad)
    with pytest.raises(ValueError, match="requires fused"):
        make_sharded_schedule_fn(mesh, resident_layout=True)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedEngine(make_mesh(3, device="cpu")).schedule_batch(snap, pods)


def test_torch_mesh_collectives_and_devices():
    """Collectives reduce in shard order on the lead device and hand every
    shard the result; a repeated-device mesh shares one tensor."""
    mesh = make_mesh(3, device="cpu")
    assert isinstance(mesh, Mesh) and mesh.size == 3
    assert all(d == torch.device("cpu") for d in mesh.devices)
    xs = [torch.tensor([1.0, 5.0]), torch.tensor([4.0, 2.0]), torch.tensor([3.0, 9.0])]
    for fn, want in ((mesh_mod.psum, [8.0, 16.0]), (mesh_mod.pmax, [4.0, 9.0]),
                     (mesh_mod.pmin, [1.0, 2.0])):
        out = fn(xs, mesh)
        assert len(out) == 3 and all(o.tolist() == want for o in out)
        assert out[0] is out[1] is out[2]
    gathered = mesh_mod.all_gather(xs, mesh)
    assert gathered[0].tolist() == [[1.0, 5.0], [4.0, 2.0], [3.0, 9.0]]
    assert mesh_mod.gather_cat(xs, mesh).tolist() == [1.0, 5.0, 4.0, 2.0, 3.0, 9.0]
    assert make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError):
        Mesh([])


def test_torch_mesh_stack_shard_deltas_match_reference():
    """stack_shard_deltas over routed deltas equals the reference's leaf for
    leaf (rows, values, sentinel pads, the [D, n_local] mask plane)."""
    rng = np.random.default_rng(2)
    n, r = 64, 3
    alloc = rng.integers(4000, 16000, (n, r)).astype(np.float32)

    def snap(seed):
        g = np.random.default_rng(seed)
        s = ref_engine.make_snapshot(
            allocatable=alloc, requested=g.integers(0, 4000, (n, r)).astype(np.float32),
            disk_io=g.uniform(0, 50, n), cpu_pct=g.uniform(0, 100, n),
            mem_pct=g.uniform(0, 100, n))
        return type(s)(*[np.asarray(x) for x in s])

    prev, new = snap(1), snap(2)
    delta = ref_snap.snapshot_delta(prev, new)
    for d in (2, 4, 8):
        routed = shard_snapshot_delta(delta, d, prev_node_mask=prev.node_mask)
        got = stack_shard_deltas(delta, routed, d)
        want = ref_par.stack_shard_deltas(
            delta, ref_snap.shard_snapshot_delta(delta, d, prev_node_mask=prev.node_mask), d)
        for name in want._fields:
            np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                          np.asarray(getattr(want, name)), err_msg=name)


@pytest.fixture(scope="module")
def reference_problem():
    rs = ref_cluster(64, seed=21, gpu=True)
    rp = ref_pods(24, seed=22, gpu=True)
    return rs, rp, from_reference(rs, device="cpu"), from_reference(rp, device="cpu")


@pytest.mark.parametrize("assigner", ["greedy", "auction"], ids=["scan", "bid"])
def test_torch_mesh_matches_reference_program(reference_problem, assigner):
    """The port's 8-shard program against the JAX package's
    make_sharded_schedule_fn on its 8 virtual devices (one compile each)."""
    assert jax.device_count() == 8
    rs, rp, ts, tp = reference_problem
    want = ref_par.make_sharded_schedule_fn(ref_mesh.make_mesh(8), assigner=assigner)(rs, rp)
    got = make_sharded_schedule_fn(make_mesh(8, device="cpu"), assigner=assigner)(ts, tp)
    assert int(got.n_assigned) > 0
    _assert_batch(got, want, rp, assigner, assigner)


def _resident_snapshots(n=64, r=3, seed=5):
    rng = np.random.default_rng(seed)
    cur = {"alloc": rng.integers(4000, 16000, (n, r)).astype(np.float32)}

    def mksnap(s):
        g = np.random.default_rng(s)
        snap = make_snapshot(
            allocatable=cur["alloc"],
            requested=g.integers(0, 4000, (n, r)).astype(np.float32),
            disk_io=g.uniform(0, 50, n), cpu_pct=g.uniform(0, 100, n),
            mem_pct=g.uniform(0, 100, n), device="cpu")
        return type(snap)(*[x.numpy() for x in snap])

    pods = make_pod_batch(
        request=rng.integers(100, 3000, (24, r)).astype(np.float32),
        r_io=rng.uniform(0, 40, 24), priority=rng.integers(0, 10, 24), device="cpu")
    return cur, mksnap, pods


@pytest.mark.parametrize("kw", [
    dict(assigner="auction", normalizer="none", fused=True),
    dict(assigner="greedy", normalizer="min_max"),
], ids=["bid-k1", "scan-minmax"])
def test_torch_mesh_resident_folds(kw):
    """ShardedEngine against TorchEngine over full -> delta -> delta ->
    churn (a full upload) -> delta resident cycles, then a resident
    backlog: decisions and free_after bitwise every cycle, the same
    delta-or-full choice, and on each delta cycle per-shard routed bytes
    equal to the reference ShardedEngine's for the same delta."""
    cur, mksnap, pods = _resident_snapshots()
    se, le = ShardedEngine(make_mesh(8, device="cpu")), TorchEngine(device="cpu")
    ref_se = ref_par.ShardedEngine()
    assert ref_se.n_shards == se.n_shards == 8
    prev, epoch = None, 0
    for step in ("full", "delta", "delta", "churn", "delta"):
        epoch += 1
        if step == "churn":
            cur["alloc"] = cur["alloc"] + np.float32(1.0)
        snap = mksnap(100 + epoch)
        delta = snapshot_delta(prev, snap) if prev is not None else None
        if step == "churn":
            assert delta is None
        rs = se.schedule_resident(snap, pods, delta=delta, epoch=epoch, **kw)
        rl = le.schedule_resident(snap, pods, delta=delta, epoch=epoch, **kw)
        assert_bitwise(rs, rl, ("node_idx", "free_after", "n_assigned"), step)
        assert se.resident_used_delta == le.resident_used_delta == (step == "delta")
        ref_se._resident_dispatch(ref_engine.SnapshotArrays(*snap), delta, epoch)
        assert se.shard_delta_bytes == ref_se.shard_delta_bytes, step
        if step == "delta":
            assert sum(se.shard_delta_bytes) > 0
        prev = snap
    # the retained shards are bitwise a fresh split of the last snapshot
    fresh = ShardedEngine(se.mesh)._resident_dispatch(prev, None, 0).shards
    for got, want in zip(se._resident.shards, fresh):
        assert_bitwise(got, want, got._fields)
    w = stack_windows(make_pod_batch(
        request=np.full((16, 3), 500.0, np.float32), r_io=np.ones(16), device="cpu"), 8)
    snap = mksnap(999)
    delta = snapshot_delta(prev, snap)
    wkw = dict(kw, fused=False, normalizer="none")
    got = se.schedule_windows_resident(snap, w, delta=delta, epoch=epoch + 1, **wkw)
    want = le.schedule_windows_resident(snap, w, delta=delta, epoch=epoch + 1, **wkw)
    assert se.resident_used_delta and le.resident_used_delta
    assert_bitwise(got, want, BACKLOG_FIELDS)


def test_torch_mesh_k1_launches_once_per_shard(monkeypatch):
    """On the fused path K1 runs once per shard per window (counted at its
    wrapper, which takes the plain version on the CPU)."""
    calls = []
    original = fused.masked_score

    def counting(*a, **k):
        calls.append(a[4].shape[0])
        return original(*a, **k)

    monkeypatch.setattr(fused, "masked_score", counting)
    snap, pods = _cluster("gpu", n_pods=32)
    se = ShardedEngine(make_mesh(4, device="cpu"))
    se.schedule_batch(snap, pods, assigner="auction", normalizer="none", fused=True)
    assert calls == [16] * 4
    calls.clear()
    se.schedule_windows(snap, stack_windows(pods, 8), assigner="greedy",
                        normalizer="none", fused=True)
    assert calls == [16] * 16


def test_torch_mesh_two_tower_scorer():
    """make_sharded_learned_fn, and ShardedEngine scored by
    sharded_learned_score_fn (which absorbs `fused` and `policy`, as
    LearnedEngine does), against the dense LearnedEngine with the same
    parameters, one window and a backlog, both assigners: bitwise."""
    state, _, _ = L.init_train_state(1, model=L.NodeScorer(d_model=16, width=32), device="cpu")
    dense = L.LearnedEngine(state.params, model=L.NodeScorer(d_model=16, width=32),
                            device="cpu")
    mesh = make_mesh(8, device="cpu")
    snap, pods = _cluster("constraints", n_pods=16)
    for assigner in ("greedy", "auction"):
        kw = dict(assigner=assigner, normalizer="min_max")
        fn = L.make_sharded_learned_fn(state.params, mesh,
                                       model=L.NodeScorer(d_model=16, width=32), **kw)
        assert_bitwise(fn(snap, pods), dense.schedule_batch(snap, pods, **kw),
                       ("node_idx", "free_after", "n_assigned", "feasible"), assigner)
        wfn = L.make_sharded_learned_fn(state.params, mesh, windows=True,
                                        model=L.NodeScorer(d_model=16, width=32), **kw)
        w = stack_windows(pods, 8)
        assert_bitwise(wfn(snap, w), dense.schedule_windows(snap, w, **kw), BACKLOG_FIELDS,
                       assigner)
        se = ShardedEngine(mesh, score_fn=L.sharded_learned_score_fn(
            state.params, mesh, model=L.NodeScorer(d_model=16, width=32)))
        assert_bitwise(se.schedule_batch(snap, pods, policy="learned", fused=True, **kw),
                       dense.schedule_batch(snap, pods, **kw), BATCH_FIELDS, assigner)
        assert_bitwise(se.schedule_windows(snap, w, **kw),
                       dense.schedule_windows(snap, w, **kw), BACKLOG_FIELDS, assigner)


def _server(argv):
    from kubernetes_scheduler_tpu_torch.bridge import server as server_mod

    args = server_mod.build_parser().parse_args(
        ["--device", "cpu", "--port", "0", "--host", "127.0.0.1", *argv])
    server, port, service = server_mod.server_from_args(args)
    server.start()
    return server, port, service


def test_torch_mesh_server_route(tmp_path):
    """`--mesh-devices 4 --device cpu`: the sidecar serves a 4-shard
    ShardedEngine with the shipped manifest's options pinned (the fused
    auction); its replies are bitwise the dense in-process engine's, a
    resident session's delta cycles count per-shard bytes, a request for
    other options aborts INVALID_ARGUMENT, Preempt runs on the dense
    engine, and with --learned-checkpoint the two-tower scorer scores the
    shards. Options no sharded engine serves stop the sidecar at startup."""
    from kubernetes_scheduler_tpu_torch.bridge import RemoteEngine
    from kubernetes_scheduler_tpu_torch.bridge.client import EngineUnavailable
    from tests.test_torch_bridge import _preempt_problem

    with pytest.raises(SystemExit, match="normalizer 'none'"):
        _server(["--mesh-devices", "4", "--fused"])

    server, port, service = _server(["--mesh-devices", "4", "--assigner", "auction",
                                     "--normalizer", "none", "--fused"])
    client = RemoteEngine(f"127.0.0.1:{port}", deadline_seconds=120.0)
    try:
        snap, pods = _cluster("gpu", n_pods=16)
        kw = dict(assigner="auction", normalizer="none", fused=True)
        got = client.schedule_batch(snap, pods, **kw)
        want = DENSE.schedule_batch(snap, pods, **kw)
        for name in BATCH_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                          getattr(want, name).numpy(), err_msg=name)
        w = stack_windows(pods, 8)
        got = client.schedule_windows(snap, w, **kw)
        want = DENSE.schedule_windows(snap, w, **kw)
        np.testing.assert_array_equal(np.asarray(got.node_idx), want.node_idx.numpy())
        np.testing.assert_array_equal(np.asarray(got.free_after), want.free_after.numpy())
        with pytest.raises(EngineUnavailable, match="INVALID_ARGUMENT"):
            client.schedule_batch(snap, pods, assigner="greedy")
        psnap, pend, victims = _preempt_problem()
        got = client.preempt(psnap, pend, victims, k_cap=4)
        want = DENSE.preempt(psnap, pend, victims, k_cap=4)
        for name in ("node", "victims", "n_victims"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name).numpy())
        _, mksnap, rpods = _resident_snapshots()
        prev = None
        for epoch in range(1, 4):
            s = mksnap(200 + epoch)
            d = snapshot_delta(prev, s) if prev is not None else None
            got = client.schedule_resident(s, rpods, delta=d, epoch=epoch, **kw)
            want = DENSE.schedule_batch(s, rpods, **kw)
            np.testing.assert_array_equal(np.asarray(got.node_idx), want.node_idx.numpy())
            prev = s
        assert service.resident_deltas_served == 2
        text = service.render_metrics()
        assert 'sharded_cycles_total{rpc="schedule_batch"}' in text
        assert 'sharded_cycles_total{rpc="schedule_windows"} 1' in text
        assert 'shard_delta_bytes_total{shard="0"}' in text
    finally:
        client.close()
        server.stop(None)
    state, _, _ = L.init_train_state(8, device="cpu")
    path = str(tmp_path / "state")
    L.save_checkpoint(path, state)
    server, port, service = _server(["--mesh-devices", "4", "--learned-checkpoint", path])
    client = RemoteEngine(f"127.0.0.1:{port}", deadline_seconds=120.0)
    try:
        snap, pods = _cluster("gpu", n_pods=16)
        got = client.schedule_batch(snap, pods, policy="learned")
        want = L.load_learned_engine(path, device="cpu").schedule_batch(snap, pods)
        np.testing.assert_array_equal(np.asarray(got.node_idx), want.node_idx.numpy())
        np.testing.assert_array_equal(np.asarray(got.free_after), want.free_after.numpy())
    finally:
        client.close()
        server.stop(None)


def test_torch_mesh_scheduler_route(monkeypatch):
    """Scheduler(sharded_engine=True) on a 4-shard CPU mesh, resident and
    pipelined, binds the same pods to the same nodes in the same order as
    the Scheduler on the dense TorchEngine; its cycles count as sharded
    and its delta cycles' per-shard bytes reach the labeled counter."""
    from kubernetes_scheduler_tpu_torch.host import scheduler as port_sched
    from kubernetes_scheduler_tpu_torch.host import types as port_types
    from kubernetes_scheduler_tpu_torch.sim import host_gen as port_gen
    from kubernetes_scheduler_tpu_torch.utils import config as port_config
    from tests import test_torch_host as host

    monkeypatch.setitem(host.SIDES, "port-mesh", (
        port_sched, port_gen, port_config, port_types,
        lambda: ShardedEngine(make_mesh(4, device="cpu"))))
    for extra in ({"sharded_engine": True, "resident_state": True, "pipeline_depth": 1,
                   "max_windows_per_cycle": 1},
                  {"sharded_engine": True, "assigner": "greedy"}):
        cfg = dict(host.DEVICE, **extra)
        want, _, dense = host.drain("port", cfg)
        got, _, mesh_sched = host.drain("port-mesh", cfg)
        assert len(got) > 96 and got == want, extra
        assert mesh_sched.totals["sharded_cycles"] > 0
        assert mesh_sched.totals["fallback_cycles"] == 0
        if extra.get("resident_state"):
            assert mesh_sched.totals["shard_delta_bytes"] > 0
            rendered = "\n".join(mesh_sched.ctr_shard_bytes.render())
            assert 'shard_delta_bytes_total{shard="' in rendered
