"""The port's bridge (kubernetes_scheduler_tpu_torch.bridge) against the JAX
package's: the codec packs every engine type to the reference's bytes,
the port's server answers every RPC as the port's in-process engine does,
and the wire works across the packages both ways — the JAX package's
RemoteEngine against the port's server, and the port's RemoteEngine
against the JAX package's server — with the reference's in-process
decisions.

Tolerance. Decisions, n_assigned and free_after are equal (free_after
bitwise); masks exact. Greedy accepts a differing decision only as a
near-tie flip, under the rule tests/test_torch_engine_affinity.py states.
The reference runs unfused (fused=False) on the CPU; the port's server is
held against the port's own engine with fused=True too.
"""

import grpc
import numpy as np
import pytest
import torch

from kubernetes_scheduler_tpu import engine as ref
from kubernetes_scheduler_tpu.bridge import codec as ref_codec
from kubernetes_scheduler_tpu.bridge.client import RemoteEngine as RefRemote
from kubernetes_scheduler_tpu.bridge.server import make_server as ref_make_server
from kubernetes_scheduler_tpu.ops.preempt import VictimArrays as RefVictims
from kubernetes_scheduler_tpu.sim import gen_cluster as ref_cluster
from kubernetes_scheduler_tpu.sim import gen_pods as ref_pods
from kubernetes_scheduler_tpu_torch import TorchEngine, engine
from kubernetes_scheduler_tpu_torch.bridge import codec
from kubernetes_scheduler_tpu_torch.bridge import schedule_pb2 as pb
from kubernetes_scheduler_tpu_torch.bridge import server as port_server_mod
from kubernetes_scheduler_tpu_torch.bridge.client import (
    EngineUnavailable,
    LocalEngine,
    RemoteEngine,
)
from kubernetes_scheduler_tpu_torch.bridge.server import make_server
from kubernetes_scheduler_tpu_torch.convert import from_reference
from kubernetes_scheduler_tpu_torch.ops.preempt import VictimArrays
from tests.test_torch_engine_affinity import _assert_batch, _first_divergent_window
from tests.test_torch_resident import delta_of, next_snapshot

N_NODES, N_PODS, WINDOW = 128, 96, 32
# option sets by id (ids avoid the slow-test substrings of conftest.py)
OPTIONS = {
    "bid": dict(assigner="auction", normalizer="min_max", fused=False, affinity_aware=True),
    "scan": dict(assigner="greedy", normalizer="min_max", fused=False, affinity_aware=False),
}


def host(nt):
    return type(nt)(*[np.array(f) for f in nt])


def _problem(seed=3):
    feats = dict(constraints=True, gpu=True)
    return (host(ref_cluster(N_NODES, seed=seed, **feats)),
            host(ref_pods(N_PODS, seed=seed + 1, **feats)))


def _victims(snap, m=24, seed=42):
    rng = np.random.default_rng(seed)
    s = snap.domain_counts.shape[1]
    req = np.asarray(ref_pods(m, seed=seed).request) * 3.0
    return RefVictims(
        node=rng.integers(0, 8, m).astype(np.int32),
        prio=rng.integers(0, 5, m).astype(np.int32),
        req=req.astype(np.float32),
        mask=np.ones(m, bool),
        start=rng.integers(0, 1000, m).astype(np.int32),
        matches=np.zeros((m, s), bool),
        anti=np.zeros((m, s), bool),
    )


def _preempt_problem():
    snap, pods = _problem(seed=40)
    snap = snap._replace(requested=snap.allocatable.copy())
    pend = type(pods)(*[f[:8] for f in pods])
    pend = pend._replace(priority=np.full(8, 9, np.int32))
    return snap, pend, _victims(snap)


def as_torch(res):
    return type(res)(*[torch.from_numpy(np.array(x)) for x in res])


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_equal_results(got, want, what):
    for name in ("node_idx", "free_after", "n_assigned"):
        np.testing.assert_array_equal(
            _bits(getattr(got, name)), _bits(getattr(want, name)), err_msg=f"{what}: {name}"
        )


def assert_reference_batch(got, want, pods, kw, what):
    """`got` (numpy leaves, from the wire) against the reference's
    in-process result; greedy may differ only by a near-tie flip."""
    _assert_batch(as_torch(got), want, pods, kw["assigner"], what)


def assert_reference_backlog(got, want, snap, pods_w, kw, what):
    if kw["assigner"] == "greedy" and not np.array_equal(
            np.asarray(got.node_idx), np.asarray(want.node_idx)):
        ts, tp_w = from_reference(snap, device="cpu"), from_reference(pods_w, device="cpu")
        _first_divergent_window(ts, tp_w, snap, pods_w, kw, as_torch(got), want)
        return
    assert_equal_results(got, want, what)


@pytest.fixture(scope="module")
def port_server():
    server, port, service = make_server("127.0.0.1:0", device="cpu")
    server.start()
    yield f"127.0.0.1:{port}", service
    server.stop(grace=None)


@pytest.fixture(scope="module")
def ref_server():
    server, port, service = ref_make_server("127.0.0.1:0")
    server.start()
    yield f"127.0.0.1:{port}", service
    server.stop(grace=None)


@pytest.fixture()
def port_client(port_server):
    client = RemoteEngine(port_server[0], deadline_seconds=120.0)
    yield client
    client.close()


# ---- codec ------------------------------------------------------------------


def test_torch_codec_roundtrip_every_dtype():
    arrays = [
        np.arange(12, dtype=np.float32).reshape(3, 4),
        np.arange(6, dtype=np.float64).reshape(2, 3),
        np.arange(5, dtype=np.int32),
        np.arange(5, dtype=np.int64),
        np.array([[True, False], [False, True]]),
        np.arange(7, dtype=np.uint8),
        np.float32(3.5),
        np.zeros((0, 3), np.float32),
    ]
    for arr in arrays:
        t = codec.pack_array(arr)
        assert t.SerializeToString() == ref_codec.pack_array(arr).SerializeToString()
        out = codec.unpack_array(t)
        assert out.dtype == np.asarray(arr).dtype and out.shape == np.asarray(arr).shape
        np.testing.assert_array_equal(out, np.asarray(arr))
        # a CPU tensor packs to the same bytes as its numpy array
        tensor = torch.from_numpy(np.array(arr))
        assert codec.pack_array(tensor).SerializeToString() == t.SerializeToString()
    with pytest.raises(TypeError, match="unsupported dtype"):
        codec.pack_array(np.zeros(2, np.float16))


def test_torch_codec_refuses_device_tensors():
    """Packing never reads a tensor off its device: a tensor that is not
    on the CPU raises, naming device.to_host."""
    with pytest.raises(TypeError, match="to_host"):
        codec.pack_array(torch.empty(3, device="meta"))


def test_torch_codec_engine_types_pack_to_reference_bytes():
    """Every engine type the wire carries packs field by field to the JAX
    package's bytes and unpacks into the port's type with equal leaves."""
    snap, pods = _problem()
    new = next_snapshot(snap, np.random.default_rng(0))
    ref_delta, _ = delta_of(snap, new)
    res = host(ref.schedule_batch(snap, pods, **OPTIONS["bid"]))
    wres = host(ref.schedule_windows(snap, ref.stack_windows(pods, WINDOW), **OPTIONS["bid"]))
    cases = [
        (snap, engine.SnapshotArrays), (pods, engine.PodBatch),
        (ref_delta, engine.SnapshotDelta), (res, engine.ScheduleResult),
        (wres, engine.WindowsResult), (_victims(snap), VictimArrays),
    ]
    for nt, cls in cases:
        ours = codec.pack_fields(nt, pb.NamedTensors())
        theirs = ref_codec.pack_fields(nt, pb.NamedTensors())
        assert ours.SerializeToString(deterministic=True) == theirs.SerializeToString(
            deterministic=True), cls.__name__
        back = codec.unpack_fields(cls, ours)
        assert type(back) is cls
        for name, a, b in zip(cls._fields, nt, back):
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"{cls.__name__}.{name}")
    # the port's own tensors pack to the same bytes
    tsnap = from_reference(snap, device="cpu")
    assert codec.pack_fields(tsnap, pb.NamedTensors()).SerializeToString(
        deterministic=True) == codec.pack_fields(snap, pb.NamedTensors()).SerializeToString(
        deterministic=True)


def test_torch_codec_rejects_unknown_missing_and_bad_payload():
    _, pods = _problem()
    named = codec.pack_fields(pods, pb.NamedTensors())
    named.tensors["bogus"].CopyFrom(codec.pack_array(np.zeros(2)))
    with pytest.raises(ValueError, match="unknown"):
        codec.unpack_fields(engine.PodBatch, named)
    del named.tensors["bogus"]
    del named.tensors["request"]
    with pytest.raises(ValueError, match="missing"):
        codec.unpack_fields(engine.PodBatch, named)
    t = codec.pack_array(np.zeros((2, 3), np.float32))
    t.shape[:] = [2, 4]
    with pytest.raises(ValueError, match="elements"):
        codec.unpack_array(t)


def test_torch_codec_field_cache_markers_and_miss():
    snap, _ = _problem()
    client_cache, server_cache = {}, {}
    n1 = codec.pack_fields(snap, pb.NamedTensors(), cache=client_cache)
    assert not any(t.same_as_last for t in n1.tensors.values())
    codec.unpack_fields(engine.SnapshotArrays, n1, cache=server_cache)
    n2 = codec.pack_fields(snap, pb.NamedTensors(), cache=client_cache)
    assert all(t.same_as_last for t in n2.tensors.values())
    back2 = codec.unpack_fields(engine.SnapshotArrays, n2, cache=server_cache)
    for name, a, b in zip(snap._fields, snap, back2):
        np.testing.assert_array_equal(a, b, err_msg=name)
    snap3 = snap._replace(disk_io=snap.disk_io + 1.0)
    n3 = codec.pack_fields(snap3, pb.NamedTensors(), cache=client_cache)
    assert [k for k, t in n3.tensors.items() if not t.same_as_last] == ["disk_io"]
    back3 = codec.unpack_fields(engine.SnapshotArrays, n3, cache=server_cache)
    np.testing.assert_array_equal(back3.disk_io, snap3.disk_io)
    with pytest.raises(codec.FieldCacheMiss):
        codec.unpack_fields(engine.SnapshotArrays, n2, cache={})
    with pytest.raises(codec.FieldCacheMiss):
        codec.unpack_fields(engine.SnapshotArrays, n2, cache=None)


# ---- the port's server against the port's in-process engine -----------------

SERVER_OPTIONS = {
    **OPTIONS,
    "bid-kernel": dict(assigner="auction", normalizer="min_max", fused=True,
                       affinity_aware=False),
    "scan-kernel": dict(assigner="greedy", normalizer="none", fused=True,
                        affinity_aware=False),
}


@pytest.mark.parametrize("option", sorted(SERVER_OPTIONS))
def test_torch_server_matches_port_engine(port_client, option):
    """ScheduleBatch, ScheduleWindows and the resident session (a full
    upload, then two deltas on each surface) through the port's server
    give the port's in-process results bitwise."""
    kw = SERVER_OPTIONS[option]
    snap, pods = _problem()
    local = TorchEngine(device="cpu")
    got = port_client.schedule_batch(snap, pods, **kw)
    want = local.schedule_batch(snap, pods, **kw)
    assert_equal_results(got, host(want), f"{option} batch")
    np.testing.assert_array_equal(got.feasible, want.feasible.numpy())
    assert int(got.n_assigned) > 0 and port_client.last_engine_seconds > 0
    pods_w = ref.stack_windows(pods, WINDOW)
    got_w = port_client.schedule_windows(snap, pods_w, **kw)
    assert_equal_results(got_w, host(local.schedule_windows(snap, pods_w, **kw)),
                         f"{option} backlog")
    rng = np.random.default_rng(1)
    prev = snap
    for epoch in range(1, 4):
        new = next_snapshot(prev, rng) if epoch > 1 else prev
        delta = None if epoch == 1 else delta_of(prev, new)[1]
        got_r = port_client.schedule_resident(new, pods, delta=delta, epoch=epoch, **kw)
        assert port_client.resident_used_delta == (epoch > 1)
        assert_equal_results(got_r, host(local.schedule_batch(new, pods, **kw)),
                             f"{option} resident {epoch}")
        prev = new
    new = next_snapshot(prev, rng)
    got_rw = port_client.schedule_windows_resident(
        new, pods_w, delta=delta_of(prev, new)[1], epoch=4, **kw)
    assert port_client.resident_used_delta
    assert_equal_results(got_rw, host(local.schedule_windows(new, pods_w, **kw)),
                         f"{option} resident backlog")


def test_torch_server_evict_pass_matches_port_engine(port_client):
    snap, pend, victims = _preempt_problem()
    got = port_client.preempt(snap, pend, victims, k_cap=4)
    want = TorchEngine(device="cpu").preempt(snap, pend, victims, k_cap=4)
    for name in ("node", "victims", "n_victims"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name).numpy())
    assert (got.node >= 0).any()
    with pytest.raises(EngineUnavailable, match="INVALID_ARGUMENT"):
        port_client.preempt(snap, pend, victims, k_cap=0)


# ---- the wire across the packages --------------------------------------------


def _drive_rpc(client, rpc, kw):
    """One RPC kind through `client` and the reference's in-process answer
    for the same inputs: list of (got, want, check) triples."""
    snap, pods = _problem()
    pods_w = ref.stack_windows(pods, WINDOW)
    if rpc == "batch":
        got = client.schedule_batch(snap, pods, **kw)
        return [(got, ref.schedule_batch(snap, pods, **kw), ("batch", pods))]
    if rpc == "backlog":
        got = client.schedule_windows(snap, pods_w, **kw)
        return [(got, ref.schedule_windows(snap, pods_w, **kw), ("backlog", snap, pods_w))]
    rng = np.random.default_rng(2)
    out, prev = [], snap
    for epoch in range(1, 4):
        new = next_snapshot(prev, rng) if epoch > 1 else prev
        delta = None if epoch == 1 else delta_of(prev, new)[0]
        if rpc == "resident":
            got = client.schedule_resident(new, pods, delta=delta, epoch=epoch, **kw)
            out.append((got, ref.schedule_batch(new, pods, **kw), ("batch", pods)))
        else:
            got = client.schedule_windows_resident(new, pods_w, delta=delta, epoch=epoch, **kw)
            out.append((got, ref.schedule_windows(new, pods_w, **kw),
                        ("backlog", new, pods_w)))
        assert client.resident_used_delta == (epoch > 1), (rpc, epoch)
        prev = new
    return out


def _check(got, want, how, kw, what):
    if how[0] == "batch":
        assert_reference_batch(got, want, how[1], kw, what)
    else:
        assert_reference_backlog(got, want, how[1], how[2], kw, what)


WIRE_CASES = [(rpc, o) for rpc in ("batch", "backlog", "resident", "resident-backlog")
              for o in sorted(OPTIONS)]
WIRE_IDS = [f"{r}-{o}" for r, o in WIRE_CASES]


@pytest.mark.parametrize("rpc,option", WIRE_CASES, ids=WIRE_IDS)
def test_torch_wire_reference_client_to_port_server(port_server, rpc, option):
    kw = OPTIONS[option]
    client = RefRemote(port_server[0], deadline_seconds=120.0)
    try:
        for got, want, how in _drive_rpc(client, rpc, kw):
            _check(got, want, how, kw, f"{rpc}-{option}")
    finally:
        client.close()


@pytest.mark.parametrize("rpc,option", WIRE_CASES, ids=WIRE_IDS)
def test_torch_wire_port_client_to_reference_server(ref_server, rpc, option):
    kw = OPTIONS[option]
    client = RemoteEngine(ref_server[0], deadline_seconds=120.0)
    try:
        for got, want, how in _drive_rpc(client, rpc, kw):
            _check(got, want, how, kw, f"{rpc}-{option}")
    finally:
        client.close()


@pytest.mark.parametrize("direction", ["ref-to-port", "port-to-ref"])
def test_torch_wire_evict_pass_across_packages(port_server, ref_server, direction):
    snap, pend, victims = _preempt_problem()
    want = ref.preempt_batch(snap, pend, victims, k_cap=4)
    client = (RefRemote(port_server[0], deadline_seconds=120.0) if direction == "ref-to-port"
              else RemoteEngine(ref_server[0], deadline_seconds=120.0))
    try:
        got = client.preempt(snap, pend, victims, k_cap=4)
    finally:
        client.close()
    for name in ("node", "victims", "n_victims"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert (np.asarray(got.node) >= 0).any()


# ---- resident epochs, restarts and capability downgrades ---------------------


def test_torch_resident_epoch_mismatch_resends_in_full():
    """A delta the server cannot apply (skipped epoch, a restarted server
    holding no session) aborts resident-epoch-mismatch; the client resends
    the full snapshot transparently and the decisions stay exact."""
    kw = OPTIONS["bid"]
    snap, pods = _problem()
    rng = np.random.default_rng(3)
    new = next_snapshot(snap, rng)
    local = TorchEngine(device="cpu")
    server, port, service = make_server("127.0.0.1:0", device="cpu")
    server.start()
    client = RemoteEngine(f"127.0.0.1:{port}", deadline_seconds=120.0)
    server2 = None
    try:
        client.schedule_resident(snap, pods, epoch=1, **kw)
        # epoch 3 after 1: the delta is not applicable
        got = client.schedule_resident(new, pods, delta=delta_of(snap, new)[1], epoch=3, **kw)
        assert not client.resident_used_delta
        assert (service.resident_fulls_served, service.resident_deltas_served) == (2, 0)
        assert_equal_results(got, host(local.schedule_batch(new, pods, **kw)), "skipped epoch")
        # a restarted server on the same port has no session
        server.stop(grace=None)
        server2, _, service2 = make_server(f"127.0.0.1:{port}", device="cpu")
        server2.start()
        newer = next_snapshot(new, rng)
        got = client.schedule_resident(newer, pods, delta=delta_of(new, newer)[1], epoch=4,
                                       **kw)
        assert not client.resident_used_delta
        assert service2.resident_fulls_served == 1
        assert_equal_results(got, host(local.schedule_batch(newer, pods, **kw)), "restart")
    finally:
        client.close()
        server.stop(grace=None)
        if server2 is not None:
            server2.stop(grace=None)


class _FakeRpcError(grpc.RpcError):
    def __init__(self, code, details):
        self._code, self._details = code, details

    def code(self):
        return self._code

    def details(self):
        return self._details


def test_torch_field_cache_restart_and_failed_resend(port_server):
    """The second identical cycle rides markers; a field-cache miss is
    resent in full; a failed full resend clears the cache and the
    capability latches together, and the next cycle recovers."""
    kw = OPTIONS["scan"]
    snap, pods = _problem()
    client = RemoteEngine(port_server[0], deadline_seconds=120.0, retries=0)
    try:
        r1 = client.schedule_batch(snap, pods, **kw)
        assert client._field_cache_ok is True and client._wire_cache["batch:snapshot"]
        sent = []
        real = client._schedule

        def counting(request, timeout=None):
            sent.append(request)
            return real(request, timeout=timeout)

        client._schedule = counting
        r2 = client.schedule_batch(snap, pods, **kw)
        assert all(t.same_as_last for t in sent[-1].snapshot.tensors.values())
        np.testing.assert_array_equal(r1.node_idx, r2.node_idx)
        # the server forgets the session: a miss, then one full resend
        port_server[1]._field_cache.clear()
        r3 = client.schedule_batch(snap, pods, **kw)
        assert len(sent) == 3
        assert not any(t.same_as_last for t in sent[-1].snapshot.tensors.values())
        np.testing.assert_array_equal(r1.node_idx, r3.node_idx)
        calls = []

        def failing(request, timeout=None):
            calls.append(request)
            code = (grpc.StatusCode.FAILED_PRECONDITION if len(calls) == 1
                    else grpc.StatusCode.UNAVAILABLE)
            raise _FakeRpcError(code, "field-cache-miss: SnapshotArrays.disk_io")

        client._schedule = failing
        with pytest.raises(EngineUnavailable):
            client.schedule_batch(snap, pods, **kw)
        assert len(calls) == 2
        assert client._wire_cache == {} and client._field_cache_ok is None
        client._schedule = real
        r4 = client.schedule_batch(snap, pods, **kw)
        np.testing.assert_array_equal(r1.node_idx, r4.node_idx)
    finally:
        client.close()


def test_torch_capability_downgrades(port_server):
    """Each capability switch of the port's server, turned off, moves the
    client to its downgrade path with the same decisions: no field cache
    (no markers, no session), no gangs (gang tensors stripped), no
    resident state (plain ScheduleBatch); the fused min-max bit is off on
    the CPU and a flipped switch reaches a client after it re-probes."""
    address, service = port_server
    kw = OPTIONS["bid"]
    snap, pods = _problem()
    want = host(TorchEngine(device="cpu").schedule_batch(snap, pods, **kw))
    try:
        service.field_cache_enabled = False
        service.gang_enabled = False
        service.resident_enabled = service.windows_resident_enabled = False
        client = RemoteEngine(address, deadline_seconds=120.0)
        sent = []
        real = client._schedule

        def counting(request, timeout=None):
            sent.append(request)
            return real(request, timeout=timeout)

        client._schedule = counting
        assert not client.supports_fused_min_max()
        for _ in range(2):
            assert_equal_results(client.schedule_batch(snap, pods, **kw), want, "downgraded")
        got = client.schedule_resident(snap, pods, epoch=1, **kw)
        assert_equal_results(got, want, "resident downgraded")
        assert client._wire_cache == {} and not client.resident_used_delta
        assert all(not r.session_id and not r.resident_full for r in sent)
        assert all("gang_id" not in r.pods.tensors for r in sent)
        client.close()
        service.fused_min_max_enabled = True
        client = RemoteEngine(address, deadline_seconds=120.0)
        assert client.supports_fused_min_max()
        client.close()
    finally:
        service.field_cache_enabled = service.gang_enabled = True
        service.resident_enabled = service.windows_resident_enabled = True
        service.fused_min_max_enabled = False


def test_torch_health_and_profile_on_cpu(port_client, port_server, tmp_path):
    address, service = port_server
    assert port_client.healthy()
    info = port_client.health_info()
    assert (info.status, info.platform, info.device_count) == ("SERVING", "cpu", 1)
    assert info.cycles_served == service.cycles_served
    assert info.field_cache and info.resident_state and info.gang_scheduling
    assert not info.fused_min_max
    # a profile arm forwarded over metadata: the next call runs under
    # torch.profiler on the server and leaves its trace
    snap, pods = _problem()
    service.arm_profile(0, str(tmp_path))
    port_client.set_trace_id(7, seq=3)
    port_client.arm_profile(1)
    port_client.schedule_batch(snap, pods, **OPTIONS["scan"])
    assert (tmp_path / "step-00000007" / "trace.json").exists()
    assert 'rpcs_served_total{rpc="schedule_batch"}' in service.render_metrics()


def test_torch_slim_replies_and_rejected_options(port_client):
    snap, pods = _problem()
    slim = RemoteEngine(port_client.target, decisions_only=True, deadline_seconds=120.0)
    try:
        full = port_client.schedule_batch(snap, pods, **OPTIONS["scan"])
        thin = slim.schedule_batch(snap, pods, **OPTIONS["scan"])
    finally:
        slim.close()
    assert_equal_results(thin, full, "decisions_only")
    assert not thin.scores.any() and full.scores.any()
    with pytest.raises(EngineUnavailable, match="INVALID_ARGUMENT"):
        port_client.schedule_batch(snap, pods, policy="nope")
    # a heuristic sidecar has no learned scorer: "learned" is an unknown
    # policy to it (a --learned-checkpoint sidecar serves it)
    with pytest.raises(EngineUnavailable, match="unknown policy 'learned'"):
        port_client.schedule_batch(snap, pods, policy="learned")
    bogus = port_client._channel.unary_unary(
        "/yodatpu.Engine/DoesNotExist",
        request_serializer=pb.HealthRequest.SerializeToString,
        response_deserializer=pb.HealthReply.FromString,
    )
    with pytest.raises(NotImplementedError):
        port_client._call_with_retry(bogus, pb.HealthRequest())


def test_torch_server_refuses_unported_options():
    """A mesh across hosts (--mesh-devices 4 --mesh-hosts 2) serves a
    ShardedEngine over a (dcn, node) mesh, its replies bitwise the dense
    engine's; a device count that does not split into the host groups and
    conflicting options exit with a message before anything is built."""
    argv = ["--device", "cpu", "--port", "0"]
    server, port, service = port_server_mod.server_from_args(port_server_mod.build_parser()
        .parse_args([*argv, "--host", "127.0.0.1", "--mesh-devices", "4", "--mesh-hosts", "2"]))
    assert service._engine.mesh.axis_names == ("dcn", "node")
    assert service._engine.mesh.shape == (2, 2) and service.mesh_devices == 4
    server.start()
    client = RemoteEngine(f"127.0.0.1:{port}", deadline_seconds=120.0)
    try:
        snap, pods = _problem()
        kw = dict(assigner="greedy", normalizer="min_max", fused=False)
        got = client.schedule_batch(snap, pods, **kw)
        want = TorchEngine(device="cpu").schedule_batch(snap, pods, **kw)
        assert_equal_results(as_torch(got), want, "2 x 2 mesh")
    finally:
        client.close()
        server.stop(None)
    with pytest.raises(SystemExit, match="must divide"):
        port_server_mod.main([*argv, "--mesh-devices", "3", "--mesh-hosts", "2"])
    with pytest.raises(SystemExit, match="only configures the sharded engine"):
        port_server_mod.main([*argv, "--score-plugins", '[{"name": "least_allocated"}]'])
    with pytest.raises(SystemExit, match="incompatible with --fused"):
        port_server_mod.main([*argv, "--mesh-devices", "2", "--fused", "--score-plugins",
                              '[{"name": "least_allocated"}]'])
    assert LocalEngine is TorchEngine


def test_torch_unreachable_engine_takes_the_scalar_path():
    from kubernetes_scheduler_tpu_torch.host.advisor import NodeUtil, StaticAdvisor
    from kubernetes_scheduler_tpu_torch.host.scheduler import Scheduler
    from kubernetes_scheduler_tpu_torch.host.types import Container, Node, Pod
    from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

    client = RemoteEngine("127.0.0.1:1", deadline_seconds=0.5, retries=1)
    try:
        assert not client.healthy(timeout=0.5)
        snap, pods = _problem()
        with pytest.raises(EngineUnavailable):
            client.schedule_batch(snap, pods)
    finally:
        client.close()
    nodes = [
        Node(name=f"n{i}", allocatable={"cpu": 8000.0, "memory": 2**34, "pods": 110})
        for i in range(4)
    ]
    utils = {n.name: NodeUtil(cpu_pct=10.0 * i, mem_pct=20.0, disk_io=5.0)
             for i, n in enumerate(nodes)}
    client = RemoteEngine("127.0.0.1:1", deadline_seconds=0.3, retries=0)
    sched = Scheduler(
        SchedulerConfig(batch_window=8), advisor=StaticAdvisor(utils),
        list_nodes=lambda: nodes, list_running_pods=lambda: [], engine=client,
    )
    try:
        for i in range(3):
            sched.submit(Pod(name=f"p{i}", containers=[Container(requests={"cpu": 100.0})]))
        m = sched.run_cycle()
    finally:
        client.close()
    assert m.used_fallback and m.pods_bound == 3


def test_torch_remote_engine_surface_answers(port_client, port_server, tmp_path):
    """The sidecar client answers the whole engine surface: its own
    breaker and collectors, the server's capabilities, no device and no
    mesh of its own, a preempt and a profile arm forwarded over the wire."""
    from kubernetes_scheduler_tpu_torch.host.engine_surface import EngineSurface
    from kubernetes_scheduler_tpu_torch.host.resilience import CircuitBreaker

    missing = [n for n in vars(EngineSurface) if not n.startswith("_")
               and not hasattr(port_client, n)]
    assert not missing, missing
    assert isinstance(port_client, EngineSurface)
    assert isinstance(port_client.breaker, CircuitBreaker) and len(port_client.collectors) == 1
    assert port_client.device is None and port_client.n_shards == 0
    assert port_client.supports_resident() and port_client.supports_windows_resident()
    assert port_client.supports_gangs() and not port_client.supports_fleet()
    assert not port_client.supports_fused_min_max()
    assert port_client.healthy() and port_client.health_info().status == "SERVING"
    assert port_client.invalidate_resident() is None
    port_client.set_trace_id(5, 1)
    assert port_client.arm_profile(0)["forwarded_to"] == port_client.target
    snap, pend, victims = _preempt_problem()
    got = port_client.preempt(snap, pend, victims, k_cap=4)
    want = TorchEngine(device="cpu").preempt(snap, pend, victims, k_cap=4)
    np.testing.assert_array_equal(np.asarray(got.node), np.asarray(want.node))


def test_torch_remote_backlog_degrades_per_window_on_unimplemented(port_client):
    """A sidecar whose ScheduleWindows answers UNIMPLEMENTED: the host's
    deep-queue cycle degrades to one ScheduleBatch per window, binds
    every pod without the scalar fallback, and stops popping deep
    windows."""
    from kubernetes_scheduler_tpu_torch.host.advisor import NodeUtil, StaticAdvisor
    from kubernetes_scheduler_tpu_torch.host.scheduler import Scheduler
    from kubernetes_scheduler_tpu_torch.host.types import Container, Node, Pod
    from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

    port_client._schedule_windows = port_client._channel.unary_unary(
        "/yodatpu.Engine/DoesNotExist",
        request_serializer=pb.ScheduleRequest.SerializeToString,
        response_deserializer=pb.ScheduleReply.FromString,
    )
    batches = []
    real = port_client._schedule

    def counting(request, timeout=None, **kw):
        batches.append(request)
        return real(request, timeout=timeout, **kw)

    port_client._schedule = counting
    nodes = [
        Node(name=f"n{i}", allocatable={"cpu": 8000.0, "memory": 2**34, "pods": 110})
        for i in range(4)
    ]
    utils = {n.name: NodeUtil(cpu_pct=10.0 * i, mem_pct=20.0, disk_io=5.0)
             for i, n in enumerate(nodes)}
    sched = Scheduler(
        SchedulerConfig(batch_window=4, max_windows_per_cycle=3, min_device_work=0),
        advisor=StaticAdvisor(utils), list_nodes=lambda: nodes,
        list_running_pods=lambda: [], engine=port_client,
    )
    for i in range(12):
        sched.submit(Pod(name=f"p{i}", containers=[Container(requests={"cpu": 100.0})]))
    m = sched.run_cycle()
    assert not m.used_fallback and m.pods_bound == 12
    assert len(batches) == 3 and not sched._engine_windows_ok
    assert sched._window_cap() == 4
