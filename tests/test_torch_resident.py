"""The port's resident cluster state (kubernetes_scheduler_tpu_torch.engine:
SnapshotDelta, the in-place delta folds, FusedLayout, schedule_batch and
schedule_windows with a layout, schedule_batch_fleet, TorchEngine's
resident and async surface) against the JAX reference, on generated
clusters whose cycle-over-cycle deltas the reference's host builds
(`host.snapshot.snapshot_delta`).

Folds, layouts and the port's own resident-vs-full comparisons are held
bitwise. Against the reference, decisions, masks and free capacity are
exact and scores within chip_smoke.score_tolerance (XLA contracts the
score into FMAs on the CPU; the port does not)."""

import jax
import numpy as np
import pytest
import torch

from chip_smoke import score_tolerance
from kubernetes_scheduler_tpu import engine as ref
from kubernetes_scheduler_tpu.host.snapshot import snapshot_delta
from kubernetes_scheduler_tpu.ops import stats as ref_stats
from kubernetes_scheduler_tpu.sim import gen_cluster as ref_cluster
from kubernetes_scheduler_tpu.sim import gen_pods as ref_pods
from kubernetes_scheduler_tpu_torch import TorchEngine, engine
from kubernetes_scheduler_tpu_torch.convert import from_reference

KW = dict(assigner="auction", normalizer="min_max", fused=True, affinity_aware=False)
ASSIGNERS = {"scan": "greedy", "bid": "auction"}
N_NODES, N_PODS = 48, 32


def bits(x):
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def host(nt):
    """A NamedTuple of the reference's type with numpy leaves."""
    return type(nt)(*[np.array(f) for f in nt])


def problem(seed=5):
    feats = dict(constraints=True, gpu=True)
    return (host(ref_cluster(N_NODES, seed=seed, **feats)),
            host(ref_pods(N_PODS, seed=seed + 1, **feats)))


def next_snapshot(prev, rng, *, frac=0.2):
    """The next cycle's host build: `requested` grows on a few nodes (the
    previous cycle's placements), utilisation moves on `frac` of the
    nodes, some domain-table rows change, and one node flips its mask."""
    new = {f: np.array(getattr(prev, f)) for f in prev._fields}
    n, r = new["requested"].shape
    rows = rng.choice(n, 6, replace=False)
    new["requested"][rows] += rng.integers(1, 3, (6, r)).astype(np.float32)
    util = rng.choice(n, max(1, int(frac * n)), replace=False)
    for name in engine.UTIL_SERIES:
        new[name][util] = rng.uniform(0, 100, util.size).astype(np.float32)
    dom = rng.choice(n, 3, replace=False)
    for name in engine.DOMAIN_TABLES:
        new[name][dom] += 1.0
    new["node_mask"][rng.integers(n)] ^= True
    return type(prev)(**new)


def delta_of(prev, new, kind="numpy"):
    d = snapshot_delta(prev, new, max_byte_frac=1.0)
    assert d is not None
    leaves = [np.asarray(x) for x in d]
    if kind == "tensor":
        leaves = [torch.from_numpy(x.copy()) for x in leaves]
    return d, engine.SnapshotDelta(*leaves)


def assert_leaves_equal(got, want):
    for name in got._fields:
        a = getattr(got, name)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_array_equal(bits(a), bits(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_torch_delta_fold_matches_reference(kind):
    """The in-place fold equals the reference's device and numpy folds on
    every leaf, the bucket's sentinel rows dropped, and leaves the
    caller's delta and the reference snapshot as they were."""
    prev, _ = problem()
    new = next_snapshot(prev, np.random.default_rng(1))
    ref_delta, delta = delta_of(prev, new, kind)
    assert (np.asarray(ref_delta.req_rows) == N_NODES).any()   # sentinels present
    before = [np.array(x).copy() for x in delta]
    want_np = ref.apply_snapshot_delta_np(prev, ref_delta)
    want_dev = ref.apply_snapshot_delta(jax.device_put(prev), ref_delta)
    snap = from_reference(prev, device="cpu")
    got = engine.apply_snapshot_delta(snap, delta)
    assert got is snap   # in place
    assert_leaves_equal(got, want_np)
    assert_leaves_equal(got, want_dev)
    assert_leaves_equal(got, new)
    for a, b in zip(delta, before):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert_leaves_equal(from_reference(prev, device="cpu"), prev)


def test_torch_delta_rows_must_be_host_arrays():
    """A row family is filtered to [0, n) on the host (the sentinels never
    cross) and folds by index_copy_; rows or values already on a device
    raise (here a meta tensor stands for a card's)."""
    rng = np.random.default_rng(3)
    leaf = torch.from_numpy(rng.uniform(size=(10, 3)).astype(np.float32))
    rows = np.array([7, 10, 2, 10, 10], np.int32)
    vals = rng.uniform(size=(5, 3)).astype(np.float32)
    got = engine._upload_rows(rows, vals, 10, torch.device("cpu"))
    assert got.rows.tolist() == [7, 2]
    a = leaf.clone()
    a.index_copy_(0, got.rows, got.vals)
    want = leaf.clone()
    want[[7, 2]] = torch.from_numpy(vals[[0, 2]])
    assert torch.equal(a, want)
    on_device = torch.empty(5, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="host arrays"):
        engine._upload_rows(on_device, vals, 10, torch.device("cpu"))
    with pytest.raises(ValueError, match="host arrays"):
        engine._upload_rows(rows, torch.empty(5, 3, device="meta"), 10, torch.device("cpu"))


def test_torch_delta_np_and_nbytes_match_reference():
    prev, _ = problem(seed=7)
    new = next_snapshot(prev, np.random.default_rng(2), frac=0.5)
    ref_delta, delta = delta_of(prev, new)
    got = engine.apply_snapshot_delta_np(prev, delta)
    assert_leaves_equal(got, ref.apply_snapshot_delta_np(prev, ref_delta))
    assert engine.snapshot_nbytes(delta) == ref.snapshot_nbytes(ref_delta)
    assert engine.snapshot_nbytes(prev) == ref.snapshot_nbytes(prev)
    port = from_reference(prev, device="cpu")
    assert engine.snapshot_nbytes(port) == ref.snapshot_nbytes(prev)
    assert_leaves_equal(from_reference(prev, device="cpu"), problem(seed=7)[0])


def test_torch_layout_fold_matches_fresh_build():
    """A delta-folded layout is bitwise a fresh build of the folded
    snapshot, and its fields are the rows of the reference's layout."""
    prev, _ = problem(seed=9)
    rng = np.random.default_rng(4)
    snap = from_reference(prev, device="cpu")
    layout = engine.build_fused_layout(snap)
    cur = prev
    for _ in range(3):
        new = next_snapshot(cur, rng)
        _, delta = delta_of(cur, new)
        engine.apply_snapshot_delta(snap, delta)
        assert engine.apply_layout_delta(layout, delta) is layout
        fresh = engine.build_fused_layout(snap)
        for f in engine.FusedLayout._fields:
            a, b = getattr(layout, f), getattr(fresh, f)
            assert a.dtype == b.dtype and torch.equal(a, b), f
        cur = new
    want = ref.build_fused_layout(jax.device_put(cur))
    n = N_NODES
    node_ft = np.asarray(want.node_ft)
    # u and v: bitwise the reference's utilization_stats run eagerly; its
    # jitted layout build lets XLA turn x / 50 into x * float32(1 / 50),
    # which can round one ulp away
    stats = ref_stats.utilization_stats(cur.disk_io, cur.cpu_pct, cur.node_mask)
    for got, eager, jitted in ((layout.u, stats.u, node_ft[0, :n]),
                               (layout.v, stats.v, node_ft[1, :n])):
        np.testing.assert_array_equal(bits(got.numpy()), bits(eager))
        np.testing.assert_array_max_ulp(got.numpy(), jitted, maxulp=1)
    np.testing.assert_array_equal(layout.node_mask.numpy(), node_ft[2, :n] > 0)
    np.testing.assert_array_equal(bits(layout.alloc.numpy()),
                                  bits(np.asarray(want.alloc_t).T[:n]))
    np.testing.assert_array_equal(bits(layout.reqd.numpy()),
                                  bits(np.asarray(want.reqd_t).T[:n]))


def assert_cycle(got, want, snap, pods, kw, *, scores=True):
    np.testing.assert_array_equal(got.node_idx.numpy(), np.asarray(want.node_idx))
    np.testing.assert_array_equal(bits(got.free_after.numpy()), bits(want.free_after))
    assert int(got.n_assigned) == int(want.n_assigned)
    if scores:
        np.testing.assert_array_equal(got.feasible.numpy(), np.asarray(want.feasible))
        feas = got.feasible.numpy()
        tol = score_tolerance(snap, pods, got.scores, got.feasible, kw)
        err = np.abs(got.scores.numpy().astype(np.float64) - np.asarray(want.scores))
        assert (err[feas] <= tol[feas]).all()


def assert_bitwise(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


@pytest.mark.parametrize("assigner", list(ASSIGNERS), ids=list(ASSIGNERS))
def test_torch_layout_batch_matches_reference(assigner):
    prev, pods = problem()
    new = next_snapshot(prev, np.random.default_rng(5))
    _, delta = delta_of(prev, new)
    kw = dict(KW, assigner=ASSIGNERS[assigner])
    # the layout the resident cycle holds: built on prev, then delta-folded
    snap = from_reference(prev, device="cpu")
    layout = engine.build_fused_layout(snap)
    engine.apply_snapshot_delta(snap, delta)
    engine.apply_layout_delta(layout, delta)
    tp = from_reference(pods, device="cpu")
    got = engine.schedule_batch(snap, tp, layout=layout, **kw)
    rs = jax.device_put(new)
    want = ref.schedule_batch(rs, pods, layout=ref.build_fused_layout(rs), **kw)
    assert_cycle(got, want, snap, tp, kw)
    assert int(got.n_assigned) > 0
    assert_bitwise(got, engine.schedule_batch(snap, tp, **kw))
    # the layout is consulted on the fused path only
    unfused = dict(kw, fused=False)
    assert_bitwise(engine.schedule_batch(snap, tp, layout=layout, **unfused),
                   engine.schedule_batch(snap, tp, **unfused))


@pytest.mark.parametrize("assigner", list(ASSIGNERS), ids=list(ASSIGNERS))
def test_torch_layout_backlog_matches_reference(assigner):
    prev, pods = problem(seed=11)
    kw = dict(KW, assigner=ASSIGNERS[assigner])
    snap = from_reference(prev, device="cpu")
    layout = engine.build_fused_layout(snap)
    kept = [t.clone() for t in layout]
    tp = engine.stack_windows(from_reference(pods, device="cpu"), 8)
    got = engine.schedule_windows(snap, tp, layout=layout, **kw)
    rs = jax.device_put(prev)
    want = ref.schedule_windows(rs, ref.stack_windows(pods, 8),
                                layout=ref.build_fused_layout(rs), **kw)
    assert_cycle(got, want, None, None, kw, scores=False)
    assert_bitwise(got, engine.schedule_windows(snap, tp, **kw))
    for a, b in zip(layout, kept):   # the backlog never writes the layout
        assert torch.equal(a, b)


def test_torch_layout_requires_kernel_path():
    prev, pods = problem()
    snap = from_reference(prev, device="cpu")
    tp = engine.stack_windows(from_reference(pods, device="cpu"), 8)
    with pytest.raises(ValueError, match="layout requires fused=True"):
        engine.schedule_windows(snap, tp, layout=engine.build_fused_layout(snap),
                                **dict(KW, fused=False))


def test_torch_fleet_matches_reference_base_untouched():
    prev, pods = problem(seed=13)
    rng = np.random.default_rng(6)
    ref_d1, d1 = delta_of(prev, next_snapshot(prev, rng))
    ref_d2, d2 = delta_of(prev, next_snapshot(prev, rng, frac=0.4))
    half = lambda nt, s: type(nt)(*[f[s] for f in nt])  # noqa: E731
    ref_reqs = ((None, half(pods, slice(0, 16))), (ref_d1, half(pods, slice(16, 32))),
                (ref_d2, half(pods, slice(0, 16))))
    tp = from_reference(pods, device="cpu")
    reqs = ((None, half(tp, slice(0, 16))), (d1, half(tp, slice(16, 32))),
            (d2, half(tp, slice(0, 16))))
    base = from_reference(prev, device="cpu")
    kept = [t.clone() for t in base]
    kw = dict(KW, assigner="greedy")
    got = engine.schedule_batch_fleet(base, reqs, **kw)
    want = ref.schedule_batch_fleet(jax.device_put(prev), ref_reqs, **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_cycle(g, w, None, None, kw, scores=False)
        np.testing.assert_array_equal(g.feasible.numpy(), np.asarray(w.feasible))
    for a, b in zip(base, kept):
        assert torch.equal(a, b)
    # element 1 is the cycle its own engine would run on the folded state
    own = engine.apply_snapshot_delta(from_reference(prev, device="cpu"), d1)
    assert_bitwise(got[1], engine.schedule_batch(own, reqs[1][1], **kw))


@pytest.mark.parametrize("assigner", list(ASSIGNERS), ids=list(ASSIGNERS))
def test_torch_engine_resident_sequence_matches_local_engine(assigner):
    """TorchEngine(device="cpu") beside the reference's LocalEngine: a full
    upload, two deltas, an epoch gap, invalidate_resident, a delta, a
    resident backlog, a fleet dispatch and the async twins; the same
    resident_used_delta trail and equal results. The caller's snapshot
    tensors are never written."""
    kw = dict(KW, assigner=ASSIGNERS[assigner])
    prev, pods = problem(seed=15)
    rng = np.random.default_rng(7)
    mine, theirs = TorchEngine(device="cpu"), ref.LocalEngine()
    assert mine.supports_resident() and mine.supports_windows_resident()
    assert mine.supports_fused_min_max() and mine.supports_gangs() and mine.healthy()
    caller = from_reference(prev, device="cpu")      # tensors the caller keeps
    kept = [t.clone() for t in caller]
    trail, cur, epoch = [], prev, 0
    steps = ["full", "delta", "delta", "gap", "invalidate", "delta", "backlog", "fleet",
             "async"]
    for step in steps:
        new = next_snapshot(cur, rng) if step != "full" else cur
        _, delta = delta_of(cur, new) if step != "full" else (None, None)
        epoch += 2 if step == "gap" else 1
        if step == "invalidate":
            mine.invalidate_resident()
            theirs.invalidate_resident()
        args = dict(delta=delta, epoch=epoch)
        port_snap = caller if step == "full" else new
        if step == "backlog":
            got = mine.schedule_windows_resident(port_snap, engine.stack_windows(pods, 8),
                                                 **args, **kw)
            want = theirs.schedule_windows_resident(new, ref.stack_windows(pods, 8),
                                                    **args, **kw)
        elif step == "fleet":
            got = mine.schedule_batch_fleet(port_snap, ((None, pods),), **args, **kw)[0]
            want = theirs.schedule_batch_fleet(new, ((None, pods),), **args, **kw)[0]
        elif step == "async":
            got = mine.schedule_resident_async(port_snap, pods, **args, **kw).result()
            want = theirs.schedule_resident_async(new, pods, **args, **kw).result()
        else:
            got = mine.schedule_resident(port_snap, pods, **args, **kw)
            want = theirs.schedule_resident(new, pods, **args, **kw)
        trail.append((mine.resident_used_delta, theirs.resident_used_delta))
        assert_cycle(got, want, None, None, kw, scores=False)
        # a delta cycle is bitwise the same call on a full upload
        fresh = TorchEngine(device="cpu")
        if step == "backlog":
            assert_bitwise(got, fresh.schedule_windows(new, engine.stack_windows(pods, 8),
                                                       **kw))
        else:
            assert_bitwise(got, fresh.schedule_batch(new, pods, **kw))
        cur = new
    assert [m for m, _ in trail] == [t for _, t in trail]
    assert [m for m, _ in trail] == [False, True, True, False, False, True, True, True,
                                     True]
    for a, b in zip(caller, kept):
        assert torch.equal(a, b)
    res = mine.schedule_batch_async(cur, pods, **kw)
    assert_bitwise(res.result(), mine.schedule_batch(cur, pods, **kw))


def test_torch_engine_profile_arm_writes_step_trace(tmp_path):
    prev, pods = problem()
    eng = TorchEngine(device="cpu")
    armed = eng.arm_profile(1, str(tmp_path))
    assert armed == {"armed": 1, "out_dir": str(tmp_path)}
    eng.set_trace_id(42)
    eng.schedule_batch(prev, pods, **KW)
    assert (tmp_path / "step-00000042" / "trace.json").is_file()
    eng.schedule_batch(prev, pods, **KW)          # the arm is spent
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step-00000042"]
    eng.close()
