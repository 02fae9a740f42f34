"""The port's CLI (kubernetes_scheduler_tpu_torch.cli) and the modules
behind it: every test of tests/test_cli.py against the port's modules
(with --device cpu where a command builds an engine), the commands the
reference's CLI has beyond them (trace, scenario, shadow, spans), the
options the port refuses, and `scheduler --source kube` through both
packages' CLIs on the same fake API server, which must POST the same
bindings."""

import json

import pytest

import chip_smoke
from kubernetes_scheduler_tpu_torch import register
from kubernetes_scheduler_tpu_torch.cli import build_parser, main
from kubernetes_scheduler_tpu_torch.host.plugins import ScalarYodaPlugin
from kubernetes_scheduler_tpu_torch.sim.host_gen import gen_host_cluster, gen_host_pods
from tests import fake_kube

CPU = ["--device", "cpu"]


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_torch_register_gate():
    assert register.YODA in register.registered_plugins()
    plugin = register.make_plugin(register.YODA, utils={})
    assert isinstance(plugin, ScalarYodaPlugin)
    with pytest.raises(ValueError, match="unknown plugin"):
        register.make_plugin("nope")
    register.register_plugin("custom", lambda **kw: ScalarYodaPlugin(utils={}))
    assert "custom" in register.registered_plugins()


def test_torch_host_generators_shapes():
    nodes, advisor = gen_host_cluster(7, gpu=True, constraints=True)
    assert len(nodes) == 7
    assert len(advisor.fetch()) == 7
    assert any(n.cards for n in nodes)
    pods = gen_host_pods(13, constraints=True)
    assert len(pods) == 13
    assert all(p.annotations.get("diskIO") for p in pods)


def test_torch_command_config_roundtrip(capsys, tmp_path):
    main(["config", "--policy", "free_capacity", "--batch-window", "64"])
    out = json.loads(capsys.readouterr().out)
    assert out["policy"] == "free_capacity" and out["batch_window"] == 64
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({"policy": "balanced_diskio", "batch_window": 8}))
    main(["config", "--config", str(cfg_file), "--batch-window", "16"])
    out = json.loads(capsys.readouterr().out)
    assert out["policy"] == "balanced_diskio" and out["batch_window"] == 16


def test_torch_command_policies_lists_all(capsys):
    assert main(["policies"]) == 0
    out = capsys.readouterr().out
    for name in ("balanced_cpu_diskio", "balanced_diskio", "free_capacity", "card"):
        assert name in out
    assert "yoda-tpu" in out


def test_torch_command_scheduler_end_to_end(capsys):
    rc = main(["scheduler", "--nodes", "12", "--pods", "30", "--batch-window", "10",
               "--constraints", *CPU])
    assert rc == 0
    out = last_json(capsys)
    assert out["pods_bound"] + out["pods_unschedulable"] == 30
    assert 1 <= out["cycles"] <= 3
    assert out["fallback_cycles"] == 0


def test_torch_command_scheduler_scalar_gate(capsys):
    main(["scheduler", "--nodes", "6", "--pods", "8", "--batch-window", "8", "--no-tpu", *CPU])
    out = last_json(capsys)
    assert out["fallback_cycles"] == out["cycles"] >= 1
    assert out["pods_bound"] + out["pods_unschedulable"] == 8


def test_torch_command_replicas_shared_engine(capsys, tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"min_device_work": 0, "adaptive_dispatch": False,
                               "max_windows_per_cycle": 1}))
    rc = main(["scheduler", "--nodes", "16", "--pods", "48", "--batch-window", "8",
               "--config", str(cfg), "--replicas", "2", "--shared-engine", *CPU])
    assert rc == 0
    out = last_json(capsys)
    assert out["replicas"] == 2 and out["pods_bound"] == 48
    assert out["shared_engine"]["device_dispatches"] >= 1


def test_torch_parser_rejects_unknown_subcommand():
    with pytest.raises(SystemExit):
        build_parser().parse_args(["frobnicate"])


def test_torch_command_defaults_to_cuda():
    """Every command that builds an engine defaults to --device cuda."""
    parser = build_parser()
    for argv in (["scheduler"], ["sidecar"], ["trace", "replay", "j"],
                 ["scenario", "run", "burst"], ["shadow", "j"]):
        assert parser.parse_args(argv).device == "cuda", argv


def test_torch_command_refuses_unported_options(capsys, tmp_path):
    """bench exits 2 naming ROADMAP queue A item 11; the learned scorer
    (untrained, and from a checkpoint) and the sharded engine now
    schedule on --device cpu, every pod placed or counted."""
    assert main(["bench"]) == 2
    assert "item 11" in capsys.readouterr().err
    from kubernetes_scheduler_tpu_torch.models.learned import init_train_state, save_checkpoint

    ckpt = tmp_path / "ckpt"
    save_checkpoint(str(ckpt), init_train_state(3, device="cpu")[0])
    cfg = tmp_path / "cfg.json"
    # the engine path pinned: at this size the adaptive dispatch would
    # route the cycle to the scalar path
    cfg.write_text(json.dumps({"sharded_engine": True, "mesh_devices": 4,
                               "adaptive_dispatch": False, "min_device_work": 1}))
    small = ["--nodes", "16", "--pods", "24", "--batch-window", "12"]
    for extra in (["--policy", "learned"],
                  ["--policy", "learned", "--learned-checkpoint", str(ckpt)],
                  ["--config", str(cfg)]):
        assert main(["scheduler", *small, *extra, *CPU]) == 0, extra
        out = last_json(capsys)
        assert out["pods_bound"] > 0 and out["fallback_cycles"] == 0, (extra, out)
        assert out["pods_bound"] + out["pods_unschedulable"] == 24, (extra, out)


def test_torch_shipped_manifest_host_options_parse(monkeypatch):
    """The deploy manifest's host ConfigMap parses with the port's config,
    its host args parse with the port's CLI, and its sidecar args (a
    4-device mesh, the auction, kernel K1 per shard) build the sharded
    sidecar (on four CPU shards here). RBAC grants what the kube layer
    needs.

    The manifest's host args end in `-v`, a flag of the top-level parser
    that neither package's CLI takes after the subcommand; it is moved in
    front here, where a working invocation puts it."""
    import os

    import yaml

    from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

    path = os.path.join(os.path.dirname(__file__), "..", "deploy", "yoda-tpu-scheduler.yaml")
    docs = list(yaml.safe_load_all(open(path)))
    cm = next(d for d in docs if d.get("kind") == "ConfigMap")
    cfg = SchedulerConfig.from_dict(json.loads(cm["data"]["scheduler-config.json"]))
    assert (cfg.assigner, cfg.normalizer) == ("auction", "none")
    dep = next(d for d in docs if d.get("kind") == "Deployment")
    containers = {c["name"]: c["args"] for c in dep["spec"]["template"]["spec"]["containers"]}
    sidecar = containers.pop("tpu-engine")
    host_args = next(iter(containers.values()))
    parser = build_parser()
    with pytest.raises(SystemExit):
        parser.parse_args(host_args)
    flags = [a for a in host_args if a == "-v"]
    args = parser.parse_args(flags + [a for a in host_args if a != "-v"])
    assert (args.cmd, args.source, args.lease_kube) == ("scheduler", "kube", True)
    sargs = parser.parse_args(sidecar)
    assert sargs.mesh_devices == 4
    from kubernetes_scheduler_tpu_torch.bridge import server as server_mod

    built = {}

    def serve(server, port, service, args):
        built["service"] = service
        server.stop(None)
        return 0

    monkeypatch.setattr(server_mod, "serve", serve)
    assert main([*sidecar, "--port=0", *CPU]) == 0
    service = built["service"]
    assert service.mesh_devices == 4 and type(service._engine).__name__ == "ShardedEngine"
    assert service._pinned == {
        "policy": "balanced_cpu_diskio", "assigner": "auction", "normalizer": "none",
        "fused": True, "score_plugins": None, "auction_rounds": 1024,
        "auction_price_frac": 1.0}
    role = next(d for d in docs if d.get("kind") == "ClusterRole")
    verbs: dict[tuple, set] = {}
    for rule in role["rules"]:
        for g in rule.get("apiGroups", []):
            for r in rule.get("resources", []):
                verbs.setdefault((g, r), set()).update(rule.get("verbs", []))
    for group, resource, *need in (
        ("", "nodes", "list", "watch"),
        ("", "pods", "list", "watch", "delete"),
        ("", "pods/binding", "create"),
        ("coordination.k8s.io", "leases", "create", "get", "update"),
    ):
        assert set(need) <= verbs.get((group, resource), set()), (group, resource)


def test_torch_command_journal_tools(capsys, tmp_path):
    """scenario run --trace --spans, then trace stats/dump/diff/replay and
    spans report over what it wrote, and shadow over the journal: the
    journal replays with 0 binding diffs and the shadow diverges nowhere."""
    journal, spans = str(tmp_path / "j"), str(tmp_path / "s")
    assert main(["scenario", "list"]) == 0
    assert "burst" in capsys.readouterr().out
    assert main(["scenario", "run", "burst", "--nodes", "8", "--trace", journal,
                 "--spans", spans, *CPU]) == 0
    summary = last_json(capsys)
    assert summary["pods_bound"] > 0
    assert main(["trace", "stats", journal]) == 0
    stats = last_json(capsys)
    assert stats["records"] > 0
    assert main(["trace", "dump", journal, "--limit", "2"]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 2
    assert main(["trace", "diff", journal, journal]) == 0
    capsys.readouterr()
    out = str(tmp_path / "replayed")
    assert main(["trace", "replay", journal, "--resident", "--out", out, *CPU]) == 0
    report = last_json(capsys)
    assert report["binding_diffs"] == 0 and report["replayed"] > 0
    assert main(["trace", "diff", journal, out]) == 0
    capsys.readouterr()
    assert main(["spans", "report", spans]) == 0
    assert "engine_step" in last_json(capsys)["stages"]
    assert main(["shadow", journal, *CPU]) == 0
    shadow = last_json(capsys)
    assert shadow["divergence_ratio"] == 0.0 and shadow["records_applied"] > 0


# ---- scheduler --source kube ------------------------------------------------

N_NODES, N_PODS = 40, 48


def _kube_run(cli_main, tmp_path, capsys, extra=()):
    """`scheduler --source kube` of `cli_main` against a fresh fake API
    server holding chip_smoke.fill_live_cluster's cluster (each pod has
    one best node, so the timing of the live loop's windows cannot move a
    placement): (the POSTed bindings, the printed totals)."""
    fake = fake_kube.FakeKube().start()
    try:
        chip_smoke.fill_live_cluster(fake_kube, fake, N_NODES, N_PODS, profiles=8)
        cfg = tmp_path / "cfg.json"
        cfg.write_text(json.dumps({
            "batch_window": 16, "max_windows_per_cycle": 2, "min_device_work": 0,
            "adaptive_dispatch": False,
            "advisor": {"prometheus_host": fake.url.removeprefix("http://"),
                        "refresh_interval_seconds": 0},
        }))
        rc = cli_main(["scheduler", "--source", "kube", "--kube-server", fake.url,
                       "--config", str(cfg), "--watch-timeout", "5", *extra])
        assert rc == 0
        return sorted(fake.bindings), last_json(capsys)
    finally:
        fake.stop()


def test_torch_command_kube_source_matches_reference(tmp_path, capsys):
    """The same fake cluster through the JAX package's CLI and the port's
    (--device cpu) binds every pending pod once, to the same nodes."""
    from kubernetes_scheduler_tpu.cli import main as ref_main

    want, ref_out = _kube_run(ref_main, tmp_path, capsys)
    got, out = _kube_run(main, tmp_path, capsys, CPU)
    assert out["pods_bound"] == ref_out["pods_bound"] == N_PODS
    assert len({k for k, _ in got}) == len(got) == N_PODS
    assert got == want


def test_torch_command_kube_source_through_server(tmp_path, capsys):
    """`--engine <address>`: the same run through the port's server on
    the CPU POSTs the bindings of the in-process engine."""
    from kubernetes_scheduler_tpu_torch.bridge.server import make_server

    local, _ = _kube_run(main, tmp_path, capsys, CPU)
    server, port, service = make_server("127.0.0.1:0", device="cpu")
    server.start()
    try:
        remote, out = _kube_run(main, tmp_path, capsys, ["--engine", f"127.0.0.1:{port}"])
    finally:
        server.stop(grace=None)
    assert out["pods_bound"] == N_PODS and service.cycles_served >= 1
    assert remote == local
