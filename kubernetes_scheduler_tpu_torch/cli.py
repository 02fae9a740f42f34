"""Process entry: the cmd/scheduler/main.go analog.

Subcommands:

    scheduler  run the scheduling loop (simulated cluster or a live API
               server), the reference's single binary role
    sidecar    run the gRPC engine server (the device half of the pod pair)
    trace      flight-recorder journals: dump/stats/diff/replay/trend
    scenario   seeded adversarial traffic programs over the host loop
    shadow     score a live journal through a candidate config
    spans      span timelines: merge, report, diff
    config     print the effective SchedulerConfig as JSON
    policies   list registered score policies and plugins

The reference's main() seeds the RNG, builds the cobra command through the
register shim and executes it (cmd/scheduler/main.go:12-21); here the
register shim is kubernetes_scheduler_tpu_torch.register and the "embedded
upstream framework" is host.Scheduler.

The port's copy of kubernetes_scheduler_tpu/cli.py (`python -m
kubernetes_scheduler_tpu_torch`): every command that builds an engine
builds TorchEngine(device=--device), cuda by default, which raises
without CUDA; policy "learned" (`--learned-checkpoint`) builds the
LearnedEngine and `sharded_engine` the ShardedEngine there instead
(host.scheduler.default_engine), and `sidecar --mesh-devices N
[--mesh-hosts H]` serves the sharded programs. `bench` runs the port's
benchmark (kubernetes_scheduler_tpu_torch/bench.py) in its default mode on
--device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time

import numpy as np

from kubernetes_scheduler_tpu_torch.utils.config import SchedulerConfig

log = logging.getLogger("yoda_tpu.cli")


def _engine(args, cfg: SchedulerConfig | None = None):
    """The cycle engine a command runs on: "local" is the engine `cfg`
    asks for (host.scheduler.default_engine: TorchEngine, or the learned
    or sharded engine) on --device (cuda unless given; raises without
    CUDA), anything else a sidecar's gRPC target."""
    if args.engine and args.engine != "local":
        from kubernetes_scheduler_tpu_torch.bridge.client import RemoteEngine

        return RemoteEngine(args.engine)
    from kubernetes_scheduler_tpu_torch.host.scheduler import default_engine

    return default_engine(cfg or SchedulerConfig(), device=args.device)


def _load_config(args) -> SchedulerConfig:
    cfg = (
        SchedulerConfig.from_json(args.config)
        if getattr(args, "config", None)
        else SchedulerConfig()
    )
    for key in (
        "policy", "assigner", "normalizer", "batch_window",
        "learned_checkpoint", "trace_path", "span_path",
    ):
        v = getattr(args, key, None)
        if v is not None:
            cfg = dataclasses.replace(cfg, **{key: v})
    if getattr(args, "no_tpu", False):
        cfg.feature_gates.tpu_batch_score = False
    return cfg


def _add_config_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", help="SchedulerConfig JSON file")
    p.add_argument("--policy", choices=None, help="score policy override")
    p.add_argument("--assigner", choices=("greedy", "auction"))
    p.add_argument("--normalizer", choices=("min_max", "softmax", "none"))
    p.add_argument("--batch-window", type=int, dest="batch_window")
    p.add_argument(
        "--learned-checkpoint",
        dest="learned_checkpoint",
        help="checkpoint for policy=learned (models/learned.save_checkpoint's "
        "directory; not an orbax checkpoint: convert.learned_from_reference "
        "carries the JAX package's parameters across)",
    )
    p.add_argument(
        "--no-tpu",
        action="store_true",
        help="feature-gate TPUBatchScore=false: scalar fallback path only",
    )
    p.add_argument(
        "--trace",
        dest="trace_path",
        help="cycle flight recorder: journal every cycle under this "
        "directory (trace/; replay with `yoda-tpu trace replay`)",
    )
    p.add_argument(
        "--spans",
        dest="span_path",
        help="per-cycle span telemetry: Chrome-trace-event JSON under "
        "this directory (join with the sidecar's via "
        "`yoda-tpu spans merge`; open in Perfetto)",
    )


def _kube_config(args):
    """Resolve API-server connection: explicit flags > kubeconfig file >
    in-cluster service account > default kubeconfig (the GetConfigOrDie
    resolution order, pkg/yoda/scheduler.go:58)."""
    from kubernetes_scheduler_tpu_torch.kube import KubeConfig

    if args.kube_server:
        # token_path (not a one-shot read): survives kubelet rotation of
        # projected service-account tokens
        return KubeConfig(
            base_url=args.kube_server,
            token_path=args.kube_token_file,
            ca_path=args.kube_ca,
            insecure=args.kube_insecure,
            namespace=args.kube_namespace or "default",
        )
    if args.kubeconfig:
        return KubeConfig.from_kubeconfig(args.kubeconfig)
    try:
        return KubeConfig.in_cluster()
    except (RuntimeError, FileNotFoundError):
        return KubeConfig.from_kubeconfig()


def cmd_scheduler_kube(args, cfg) -> int:
    """Live-cluster mode: list/watch via the API server, bind via the
    Binding subresource, leader-elect on the cluster Lease."""
    from kubernetes_scheduler_tpu_torch.host.advisor import (
        BackgroundAdvisor,
        PrometheusAdvisor,
    )
    from kubernetes_scheduler_tpu_torch.host.leader import LeaderElector
    from kubernetes_scheduler_tpu_torch.host.scheduler import Scheduler
    from kubernetes_scheduler_tpu_torch.kube import (
        KubeBinder,
        KubeClient,
        KubeClusterSource,
        KubeEvictor,
        KubeLease,
    )
    from kubernetes_scheduler_tpu_torch.kube.source import InformerCache, run_kube_loop

    engine = _engine(args, cfg)
    client = KubeClient(_kube_config(args))
    # informer-style cache: nodes + assigned pods maintained by watch
    # threads, so cycles read local state instead of re-listing the
    # cluster each time (the upstream snapshot-from-informers pattern)
    cache = InformerCache(client, watch_timeout=args.watch_timeout).start()
    if not cache.wait_synced(timeout=60.0):
        log.error("informer cache failed to sync within 60s")
        return 1
    source = KubeClusterSource(
        client,
        scheduler_name=cfg.scheduler_name,
        namespace=args.kube_namespace,
        cache=cache,
    )
    # background refresh keeps the five Prometheus round-trips OFF the
    # scheduling cycle's latency path (the reference pays them inside
    # PreScore); refresh_interval_seconds=0 restores direct fetching
    advisor = PrometheusAdvisor(cfg.advisor.prometheus_host)
    if cfg.advisor.refresh_interval_seconds > 0:
        advisor = BackgroundAdvisor(
            advisor,
            interval=cfg.advisor.refresh_interval_seconds,
            max_staleness=cfg.advisor.max_staleness_seconds,
        )
    sched = Scheduler(
        cfg,
        advisor=advisor,
        binder=KubeBinder(client, cache=cache, volumes=source.volumes),
        evictor=KubeEvictor(client),
        list_nodes=source.list_nodes,
        list_running_pods=source.list_running_pods,
        list_pdbs=source.list_pdbs,
        controller_replicas=source.controller_replicas,
        engine=engine,
    )
    if sched.mirror is not None:
        # streaming ingestion (config.snapshot_mirror): the informer's
        # node/pod watch events feed the mirror directly; relists reseed
        from kubernetes_scheduler_tpu_torch.kube.source import attach_mirror

        attach_mirror(cache, sched)
    # exporter FIRST: a standby replica blocks in acquire_blocking below,
    # and it must serve /healthz + /metrics for its whole standby life
    # (the deploy manifest's readinessProbe) — upstream kube-scheduler
    # serves healthz while passive too
    exporter = None
    if args.metrics_port:
        from kubernetes_scheduler_tpu_torch.host.observe import MetricsExporter

        exporter = MetricsExporter(sched)
        exporter.serve(args.metrics_port, host=cfg.metrics_bind_host)
    elector = None
    if args.lease_kube or args.lease:
        if args.lease_kube:
            lease = KubeLease(client, name=f"{cfg.scheduler_name}-scheduler")
        else:
            # --lease (file) stays honored under --source=kube: silently
            # ignoring it would run an HA pair with NO leader election
            from kubernetes_scheduler_tpu_torch.host.leader import FileLease

            lease = FileLease(args.lease)
        elector = LeaderElector(lease, identity=args.lease_identity)
        log.info("waiting for leadership")
    try:
        if elector is not None:
            # inside the try: a SIGTERM landing right after the claim
            # succeeds must still release through the finally below
            elector.acquire_blocking()
        cycles = run_kube_loop(
            sched,
            source,
            max_cycles=None if args.serve_forever else args.max_cycles,
            elector=elector,
            exit_when_idle=not args.serve_forever,
            watch_timeout=args.watch_timeout,
        )
    except (KeyboardInterrupt, SystemExit):
        cycles = sched.totals["cycles"]
    finally:
        cache.stop()
        if sched.recorder is not None:
            sched.recorder.close()
        if sched.spans is not None:
            sched.spans.close()
        if hasattr(advisor, "close"):
            advisor.close()  # stop the background refresh thread
        if elector is not None:
            elector.release()
        if exporter is not None:
            exporter.close()
    # totals, not the (bounded) metrics window: run-lifetime counts
    print(
        json.dumps(
            {
                "cycles": cycles,
                "pods_bound": sched.totals["pods_bound"],
                "pods_unschedulable": sched.totals["pods_unschedulable"],
                "pods_dropped": sched.totals["pods_dropped"],
            }
        )
    )
    return 0


def cmd_scheduler(args) -> int:
    from kubernetes_scheduler_tpu_torch.host.scheduler import Scheduler
    from kubernetes_scheduler_tpu_torch.sim.host_gen import gen_host_cluster, gen_host_pods

    cfg = _load_config(args)
    if args.source == "kube":
        if args.replicas > 1:
            log.error(
                "--replicas is the sim-source fleet runner; a kube "
                "deployment scales by running one process per "
                "membership slot (see README: Replicated schedulers)"
            )
            return 2
        return cmd_scheduler_kube(args, cfg)
    nodes, advisor = gen_host_cluster(
        args.nodes, seed=args.seed, gpu=args.gpu, constraints=args.constraints
    )
    pods = gen_host_pods(
        args.pods, seed=args.seed + 1, gpu=args.gpu, constraints=args.constraints
    )

    if args.replicas > 1:
        if getattr(args, "shared_engine", False) and not cfg.shared_engine:
            import dataclasses

            cfg = dataclasses.replace(
                cfg, shared_engine=True,
                # the coalescing seam is the async-dispatch path
                pipeline_depth=max(1, cfg.pipeline_depth),
            )
        return _cmd_scheduler_replicated(args, cfg, nodes, advisor, pods)

    engine = _engine(args, cfg)

    running: list = []
    sched = Scheduler(
        cfg,
        advisor=advisor,
        list_nodes=lambda: nodes,
        list_running_pods=lambda: running,
        engine=engine,
    )
    elector = None
    if args.lease:
        from kubernetes_scheduler_tpu_torch.host.leader import FileLease, LeaderElector

        elector = LeaderElector(FileLease(args.lease), identity=args.lease_identity)
        log.info("waiting for leadership on %s", args.lease)

    exporter = None
    if args.metrics_port:
        from kubernetes_scheduler_tpu_torch.host.observe import MetricsExporter

        exporter = MetricsExporter(sched)
        exporter.serve(args.metrics_port, host=cfg.metrics_bind_host)

    for pod in pods:
        sched.submit(pod)
    t0 = time.perf_counter()
    try:
        if elector is not None:
            elector.acquire_blocking()
        cycles = sched.run_until_empty(max_cycles=args.max_cycles)
    finally:
        # SIGTERM (SystemExit via _terminate) must still release the
        # lease — an unreleased lease stalls standby failover — close
        # the flight-recorder journal, and close the exporter; on the
        # normal path these are no-ops for the exporter in serve-forever
        # mode, handled below
        if elector is not None:
            elector.release()
        if sched.recorder is not None:
            sched.recorder.close()
        if sched.spans is not None:
            sched.spans.close()
    dt = time.perf_counter() - t0
    for binding in sched.binder.bindings:
        running.append(binding.pod)
    bound = sum(c.pods_bound for c in cycles)
    unsched = sum(c.pods_unschedulable for c in cycles)
    print(
        json.dumps(
            {
                "cycles": len(cycles),
                "pods_bound": bound,
                "pods_unschedulable": unsched,
                "seconds": round(dt, 3),
                "pods_per_sec": round(bound / dt, 1) if dt > 0 else None,
                "fallback_cycles": sum(c.used_fallback for c in cycles),
                # bind latency = full cycle wall time (queue pop -> binds),
                # the BASELINE.md north-star latency metric
                "cycle_p50_ms": round(
                    1e3 * float(np.percentile([c.cycle_seconds for c in cycles], 50)), 2
                ) if cycles else None,
                "cycle_p99_ms": round(
                    1e3 * float(np.percentile([c.cycle_seconds for c in cycles], 99)), 2
                ) if cycles else None,
            }
        )
    )
    if exporter is not None and not args.serve_forever:
        exporter.close()
    if args.serve_forever and exporter is not None:
        log.info("metrics on :%d; ctrl-c to exit", args.metrics_port)
        try:
            while True:
                time.sleep(3600)
        except (KeyboardInterrupt, SystemExit):
            exporter.close()
    return 0


def _cmd_scheduler_replicated(args, cfg, nodes, advisor, pods) -> int:
    """`yoda-tpu scheduler --replicas N`: the replicated fleet — N full
    scheduler loops over one partitioned queue and one first-bind-wins
    bind table (host/replica.py). With --lease, each replica loop first
    JOINS the elected membership (host/leader.ReplicaMembership: N slot
    leases at <lease>.slot<i>, slot index == partition index), so a
    second fleet process started against the same lease path finds all
    slots held and stands by — the single-lease active/passive story,
    generalized to N active."""
    from kubernetes_scheduler_tpu_torch.host.queue import namespace_partition
    from kubernetes_scheduler_tpu_torch.host.replica import ReplicaFleet

    n = args.replicas
    engine_factory = None
    if args.engine and args.engine != "local":
        from kubernetes_scheduler_tpu_torch.bridge.client import RemoteEngine

        engine_factory = lambda i: RemoteEngine(args.engine)  # noqa: E731

    memberships = []
    if args.lease:
        from kubernetes_scheduler_tpu_torch.host.leader import ReplicaMembership

        for i in range(n):
            # per-loop identity suffix: one shared identity would make
            # every loop's slot lease look like the same holder
            m = ReplicaMembership.on_files(
                args.lease, n,
                identity=(
                    f"{args.lease_identity}-r{i}"
                    if args.lease_identity else None
                ),
            )
            # blocks while every slot is held — the standby posture,
            # exactly like the single-lease acquire_blocking()
            slot = m.join()
            log.info("replica loop %d holds membership slot %s", i, slot)
            memberships.append(m)

    running: list = []
    fleet = ReplicaFleet(
        cfg,
        n_replicas=n,
        advisor_factory=lambda i: advisor,
        list_nodes=lambda: nodes,
        list_running_pods=lambda: running,
        engine_factory=engine_factory,
        device=args.device,
    )

    # the generated pods all live in "default"; spread them over one
    # tenant namespace per partition (round-robin, exactly balanced for
    # any N) so every replica owns real traffic
    ns_for = {}
    i = 0
    while len(ns_for) < n:
        ns = f"tenant-{i}"
        ns_for.setdefault(namespace_partition(ns, n), ns)
        i += 1
    for j, pod in enumerate(pods):
        pod.namespace = ns_for[j % n]
        fleet.submit(pod)

    exporters = []
    if args.metrics_port:
        from kubernetes_scheduler_tpu_torch.host.observe import MetricsExporter

        class _ReplicaMetricsView:
            """Exporter facade for replica i: the scheduler's own
            surfaces plus the SHARED fleet counters (every replica's
            /metrics shows the whole fleet's conflict picture)."""

            def __init__(self, idx):
                self._sched = fleet.schedulers[idx]
                self._idx = idx

            def __getattr__(self, name):
                return getattr(self._sched, name)

            @property
            def prom_collectors(self):
                return fleet.prom_collectors(self._idx)

        for i in range(n):
            exporter = MetricsExporter(_ReplicaMetricsView(i))
            exporter.serve(args.metrics_port + i, host=cfg.metrics_bind_host)
            exporters.append(exporter)

    t0 = time.perf_counter()
    try:
        evidence = fleet.run_until_empty(max_cycles=args.max_cycles)
    finally:
        for sched in fleet.schedulers:
            if sched.recorder is not None:
                sched.recorder.close()
            if sched.spans is not None:
                sched.spans.close()
        for m in memberships:
            m.leave()
    dt = time.perf_counter() - t0
    cycles = [
        c for result in evidence.pop("replica_results") for c in result
    ]
    bound = sum(c.pods_bound for c in cycles)
    lat = [c.cycle_seconds for c in cycles]
    print(
        json.dumps(
            {
                "replicas": n,
                "cycles": len(cycles),
                "pods_bound": bound,
                "pods_unschedulable": sum(
                    c.pods_unschedulable for c in cycles
                ),
                "seconds": round(dt, 3),
                "pods_per_sec": round(bound / dt, 1) if dt > 0 else None,
                "fallback_cycles": sum(c.used_fallback for c in cycles),
                "cycle_p50_ms": round(
                    1e3 * float(np.percentile(lat, 50)), 2
                ) if cycles else None,
                "cycle_p99_ms": round(
                    1e3 * float(np.percentile(lat, 99)), 2
                ) if cycles else None,
                **evidence,
            }
        )
    )
    if args.serve_forever and exporters:
        log.info("metrics on :%d..%d; ctrl-c to exit",
                 args.metrics_port, args.metrics_port + n - 1)
        try:
            while True:
                time.sleep(3600)
        except (KeyboardInterrupt, SystemExit):
            pass
    for exporter in exporters:
        exporter.close()
    return 0


def cmd_sidecar(args) -> int:
    from kubernetes_scheduler_tpu_torch.bridge import server

    argv = ["--port", str(args.port), "--device", args.device]
    if args.metrics_port:
        argv += [
            "--metrics-port", str(args.metrics_port),
            "--metrics-host", args.metrics_host,
        ]
    if args.span_path:
        argv += ["--span-path", args.span_path]
    if args.profile_path:
        argv += ["--profile-path", args.profile_path]
    if args.step_slo_ms:
        argv += ["--step-slo-ms", str(args.step_slo_ms)]
    if args.learned_checkpoint:
        argv += ["--learned-checkpoint", args.learned_checkpoint]
    if args.mesh_devices:
        # the mesh options configure the sharded engine's programs
        argv += [
            "--mesh-devices", str(args.mesh_devices),
            "--mesh-hosts", str(args.mesh_hosts),
            "--assigner", args.assigner, "--normalizer", args.normalizer,
            "--auction-rounds", str(args.auction_rounds),
            "--auction-price-frac", str(args.auction_price_frac),
        ]
        if args.fused:
            argv.append("--fused")
    return server.main(argv)


def cmd_bench(args) -> int:
    """The benchmark's default mode (the engine rows and the host-loop
    block) on --device; its exit code."""
    from kubernetes_scheduler_tpu_torch import bench

    return bench.main(["--device", args.device])


def cmd_trace(args) -> int:
    """Flight-recorder journal tooling: stats/dump read a journal
    without an engine; diff compares two journals on decision content;
    replay re-executes one and exits non-zero on any binding diff."""
    from kubernetes_scheduler_tpu_torch.trace import inspect as tinspect

    if args.trace_cmd == "stats":
        print(json.dumps(tinspect.stats(args.journal)))
        return 0
    if args.trace_cmd == "dump":
        for line in tinspect.dump(args.journal, limit=args.limit):
            print(json.dumps(line))
        return 0
    if args.trace_cmd == "trend":
        from kubernetes_scheduler_tpu_torch.trace.recorder import TraceError
        from kubernetes_scheduler_tpu_torch.trace.trend import (
            TrendError,
            journal_trend,
        )

        try:
            report = journal_trend(
                args.journal,
                windows=args.windows,
                threshold_pct=args.threshold_pct,
                min_ms=args.min_ms,
            )
        except (TraceError, TrendError) as e:
            print(json.dumps({"error": str(e)}))
            return 2
        print(json.dumps(report))
        return 0 if report["clean"] else 1
    if args.trace_cmd == "diff":
        report = tinspect.diff(args.journal, args.other)
        print(json.dumps(report))
        clean = (
            report["differences"] == 0
            and report["extra_records_a"] == 0
            and report["extra_records_b"] == 0
            and not report.get("truncated")
        )
        return 0 if clean else 1
    # replay
    from kubernetes_scheduler_tpu_torch.trace.replay import replay_journal

    engine = _engine(args)
    try:
        report = replay_journal(
            args.journal,
            engine=engine,
            mode=args.mode,
            resident=args.resident,
            record_path=args.out,
            span_path=args.span_path,
        )
    finally:
        if engine is not None:
            engine.close()
    print(json.dumps(report.to_dict()))
    return 1 if report.binding_diffs else 0


def cmd_scenario(args) -> int:
    """Scenario harness (sim/scenarios): seeded adversarial traffic
    programs over the host loop. `list` names them; `run` drives one and
    prints its summary JSON line — with --trace, the run emits a
    flight-recorder journal that `trace replay` must reproduce with zero
    binding diffs (every scenario is replay-pinned)."""
    from kubernetes_scheduler_tpu_torch.sim import scenarios

    if args.scenario_cmd == "list":
        for name in sorted(scenarios.SCENARIOS):
            cls = scenarios.SCENARIOS[name]
            smoke = " [smoke]" if cls.smoke else ""
            print(f"{name:20s} {cls.description}{smoke}")
        return 0
    # run
    overrides: dict = {}
    if args.pipeline:
        overrides["pipeline_depth"] = 1
    if args.resident:
        overrides["resident_state"] = True
        overrides["pipeline_depth"] = 1
    if args.gang_off:
        overrides["gang_scheduling"] = False
    if args.mirror:
        overrides["snapshot_mirror"] = True
    if args.shared_engine:
        # fleet-shared device engine (host/engine_pool): replicated
        # scenarios multiplex every replica onto ONE engine and drain
        # through the split-phase seam so each round-robin round
        # coalesces into one device invocation
        overrides["shared_engine"] = True
        overrides["pipeline_depth"] = 1
    # a chaos program's own config knobs (sim/faults.py: mirror/
    # resident/stale-TTL/breaker settings its fault plan targets) are
    # the baseline; explicit flags win on conflict
    cls = scenarios.SCENARIOS.get(args.name)
    merged = dict(getattr(cls, "config_overrides", {}) or {}) if cls else {}
    merged.update(overrides)
    cfg = scenarios.scenario_config(merged)
    summary = scenarios.run(
        args.name,
        n_nodes=args.nodes,
        intensity=args.intensity,
        seed=args.seed,
        trace_path=args.trace_path,
        span_path=args.span_path,
        config=cfg,
        faults=not args.no_faults,
        device=args.device,
    )
    print(json.dumps(summary))
    if args.require_recovery and not summary.get("recovered", True):
        print(
            "scenario did not fully recover: "
            + json.dumps(
                {
                    "degradation_rungs": summary.get("degradation_rungs"),
                    "breaker_state": summary.get("breaker_state"),
                    "advisor_breaker_state": summary.get(
                        "advisor_breaker_state"
                    ),
                }
            ),
            file=sys.stderr,
        )
        return 1
    return 0


def cmd_shadow(args) -> int:
    """Shadow-mode serving (host/shadow.py): tail a live flight-recorder
    journal and re-score every cycle through a CANDIDATE config, zero
    writes to the bind path. Prints the decision/latency-diff summary as
    one JSON line; with --metrics-port the shadow's own exporter serves
    the divergence series for Prometheus (the continuous rollout gate);
    --max-divergence-ratio turns the summary into an exit code."""
    from kubernetes_scheduler_tpu_torch.host.shadow import ShadowScheduler
    from kubernetes_scheduler_tpu_torch.trace.recorder import last_journal_seq

    cfg = (
        SchedulerConfig.from_json(args.candidate_config)
        if args.candidate_config
        else SchedulerConfig()
    )
    resume = args.resume_seq
    if args.resume_end:
        resume = last_journal_seq(args.journal)
    shadow = ShadowScheduler(
        args.journal,
        cfg,
        mode=args.mode,
        resume_seq=resume,
        span_path=args.span_path,
        device=args.device,
    )
    if args.metrics_port is not None:
        port = shadow.serve(args.metrics_port, host=args.metrics_host)
        print(json.dumps({"shadow_metrics_port": port}), flush=True)
    try:
        summary = shadow.run(
            follow=args.follow,
            poll_interval_s=args.poll_interval_s,
            idle_timeout_s=args.idle_timeout_s,
            limit=args.limit,
        )
    finally:
        shadow.close()
    print(json.dumps(summary))
    if (
        args.max_divergence_ratio is not None
        and summary["divergence_ratio"] > args.max_divergence_ratio
    ):
        return 1
    return 0


def cmd_spans(args) -> int:
    """Span-timeline tooling: `merge` joins host + sidecar span
    directories on the shared trace ids into ONE Perfetto-loadable
    Chrome trace (non-zero exit when the two sides share no ids —
    broken metadata propagation); `report` turns a span source into
    per-stage percentiles + the cycle budget attribution table
    (trace/analyze.py); `diff` compares two sources with per-stage
    relative thresholds and exits non-zero on any regression — the
    CI-able perf gate."""
    from kubernetes_scheduler_tpu_torch.trace import spans as tspans

    if args.spans_cmd == "report":
        from kubernetes_scheduler_tpu_torch.trace.analyze import (
            AnalyzeError,
            build_report,
        )

        if args.trend:
            from kubernetes_scheduler_tpu_torch.trace.trend import (
                TrendError,
                build_trend,
            )

            try:
                report = build_trend(
                    args.source,
                    windows=args.trend_windows,
                    warmup=args.trend_warmup,
                    threshold_pct=args.threshold_pct,
                    min_ms=args.min_ms,
                )
            except (AnalyzeError, TrendError) as e:
                print(json.dumps({"error": str(e)}))
                return 2
            print(json.dumps(report))
            return 0 if report["clean"] else 1
        try:
            report = build_report(args.source)
        except AnalyzeError as e:
            print(json.dumps({"error": str(e)}))
            return 1
        print(json.dumps(report))
        return 0
    if args.spans_cmd == "diff":
        from kubernetes_scheduler_tpu_torch.trace.analyze import (
            AnalyzeError,
            diff_reports,
            load_report,
        )

        stage_thresholds = {}
        for spec in args.stage_threshold or ():
            stage, _, pct = spec.partition("=")
            try:
                stage_thresholds[stage] = float(pct)
            except ValueError:
                pct = None
            if not stage or pct is None:
                print(json.dumps(
                    {"error": f"--stage-threshold {spec!r}: want stage=pct"}
                ))
                return 2
        if args.trend:
            from kubernetes_scheduler_tpu_torch.trace.trend import (
                TrendError,
                trend_over_reports,
            )

            sources = [args.baseline, args.candidate, *(args.more or ())]
            try:
                report = trend_over_reports(
                    [load_report(s) for s in sources],
                    threshold_pct=args.threshold_pct,
                    min_ms=args.min_ms,
                )
            except (AnalyzeError, TrendError) as e:
                print(json.dumps({"error": str(e)}))
                return 2
            report["sources"] = sources
            print(json.dumps(report))
            return 0 if report["clean"] else 1
        if args.more:
            print(json.dumps(
                {"error": "extra span sources need --trend (pairwise "
                 "diff takes exactly baseline + candidate)"}
            ))
            return 2
        try:
            report = diff_reports(
                load_report(args.baseline),
                load_report(args.candidate),
                threshold_pct=args.threshold_pct,
                min_ms=args.min_ms,
                stage_thresholds=stage_thresholds,
            )
        except AnalyzeError as e:
            print(json.dumps({"error": str(e)}))
            return 2
        print(json.dumps(report))
        return 0 if report["clean"] else 1
    # merge
    report = tspans.merge_spans(args.host, args.sidecar, args.out)
    print(json.dumps(report))
    if report["merged_events"] == 0:
        return 1
    # a side with NO files was never configured (e.g. a local-engine
    # run has no sidecar spans) — tolerated. A side whose writer ran
    # (files exist: SpanWriter opens its first file eagerly) but
    # contributed no joinable trace ids while the other side has them
    # is the broken-propagation signal this exit code exists for.
    if report["host_trace_ids"] and report["sidecar_files"]:
        if report["joined_trace_ids"] == 0:
            return 1
    if report["sidecar_trace_ids"] and report["host_files"]:
        if report["joined_trace_ids"] == 0:
            return 1
    return 0


def cmd_config(args) -> int:
    print(json.dumps(_load_config(args).to_dict(), indent=2))
    return 0


def cmd_policies(args) -> int:
    from kubernetes_scheduler_tpu_torch import register
    from kubernetes_scheduler_tpu_torch.models.policy import HEURISTIC_POLICIES

    for name, info in sorted(HEURISTIC_POLICIES.items()):
        live = "live" if info.live_in_reference else "alternate"
        print(f"policy   {name:22s} [{live}] {info.description}  ({info.reference})")
    for name in register.registered_plugins():
        print(f"plugin   {name}")
    return 0


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", default="cuda",
        help="torch device of the engine (default cuda; raises without "
        "CUDA, pass cpu for the plain PyTorch path)",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="yoda-tpu")
    p.add_argument("-v", "--verbose", action="count", default=0)
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("scheduler", help="run the scheduling loop")
    _add_config_flags(ps)
    ps.add_argument("--nodes", type=int, default=100)
    ps.add_argument("--pods", type=int, default=200)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--gpu", action="store_true")
    ps.add_argument("--constraints", action="store_true")
    ps.add_argument("--max-cycles", type=int, default=1000)
    ps.add_argument(
        "--engine",
        default="local",
        help='"local" (in-process) or a gRPC target like "localhost:50051"',
    )
    ps.add_argument(
        "--source",
        choices=("sim", "kube"),
        default="sim",
        help='"sim" (generated cluster) or "kube" (live API server)',
    )
    ps.add_argument("--kubeconfig", help="kubeconfig path for --source kube")
    ps.add_argument("--kube-server", help="API server URL (overrides kubeconfig)")
    ps.add_argument("--kube-token-file", help="bearer token file for --kube-server")
    ps.add_argument("--kube-ca", help="CA bundle for --kube-server")
    ps.add_argument("--kube-insecure", action="store_true")
    ps.add_argument(
        "--kube-namespace",
        help="schedule only this namespace (default: all)",
    )
    ps.add_argument(
        "--watch-timeout",
        type=float,
        default=30.0,
        help="seconds per bounded pending-pod watch stream",
    )
    ps.add_argument(
        "--replicas",
        type=int,
        default=1,
        help="run N scheduler replicas over a partitioned queue with "
        "first-bind-wins fencing (sim source; with --lease each "
        "replica joins a membership slot at <lease>.slot<i>)",
    )
    ps.add_argument(
        "--shared-engine", dest="shared_engine", action="store_true",
        help="with --replicas N: multiplex the fleet onto ONE "
        "Local/Remote engine (host/engine_pool) — one resident "
        "snapshot, one upload per churn event, concurrent windows "
        "coalesced into one device invocation; with --engine <addr> "
        "the fleet shares ONE bridge client/session",
    )
    ps.add_argument("--lease", help="leader-election lease file path")
    ps.add_argument(
        "--lease-kube",
        action="store_true",
        help="leader-elect on the cluster coordination.k8s.io Lease",
    )
    ps.add_argument("--lease-identity", default=None)
    ps.add_argument("--metrics-port", type=int, default=0)
    ps.add_argument("--serve-forever", action="store_true")
    _add_device_flag(ps)
    ps.set_defaults(fn=cmd_scheduler)

    pc = sub.add_parser("sidecar", help="run the gRPC engine server")
    pc.add_argument("--port", type=int, default=50051)
    pc.add_argument(
        "--metrics-port", type=int, default=0,
        help="sidecar /metrics + /healthz + /debug/profile HTTP port "
        "(0 = disabled)",
    )
    pc.add_argument("--metrics-host", default="0.0.0.0")
    pc.add_argument(
        "--span-path", dest="span_path", default=None,
        help="server-side Chrome-trace spans under this directory",
    )
    pc.add_argument(
        "--profile-path", dest="profile_path", default=None,
        help="where /debug/profile torch.profiler dumps land",
    )
    pc.add_argument(
        "--step-slo-ms", dest="step_slo_ms", type=float, default=0.0,
        help="device-step SLO: steps slower than this bump "
        "slo_breaches_total{rpc} on the sidecar /metrics (0 = off)",
    )
    _add_device_flag(pc)
    pc.add_argument(
        "--mesh-devices", type=int, default=0,
        help="shard the node axis over this many devices (0 = single "
        "device): with --device cuda the first N cards, with cpu or "
        "cuda:K that one device N times",
    )
    pc.add_argument(
        "--mesh-hosts", type=int, default=1,
        help="with --mesh-devices: split the mesh into this many host groups "
        "(a (dcn, node) mesh; --mesh-devices must divide by it)",
    )
    pc.add_argument(
        "--learned-checkpoint", dest="learned_checkpoint", default=None,
        help="serve the learned scorer from this checkpoint "
        "(models/learned.save_checkpoint's directory, not orbax)",
    )
    pc.add_argument(
        "--assigner", default="greedy", choices=["greedy", "auction"],
        help="assignment algorithm baked into the sharded engine "
        "(mesh mode only; the dense engine honors per-request assigners)",
    )
    pc.add_argument("--auction-rounds", type=int, default=1024)
    pc.add_argument("--auction-price-frac", type=float, default=1.0)
    pc.add_argument(
        "--normalizer", default="min_max",
        choices=["min_max", "softmax", "none"],
    )
    pc.add_argument(
        "--fused", action="store_true",
        help="fused score+fit (kernel K1 per shard) on the sharded engine "
        "(mesh mode only; requires --normalizer none)",
    )
    pc.set_defaults(fn=cmd_sidecar)

    pb = sub.add_parser("bench", help="run the throughput benchmark")
    _add_device_flag(pb)
    pb.set_defaults(fn=cmd_bench)

    pt = sub.add_parser(
        "trace",
        help="flight-recorder journals: dump/stats/diff/replay/trend",
    )
    tsub = pt.add_subparsers(dest="trace_cmd", required=True)
    td = tsub.add_parser("dump", help="per-record summaries as JSON lines")
    td.add_argument("journal", help="journal directory")
    td.add_argument("--limit", type=int, default=None)
    ts = tsub.add_parser("stats", help="whole-journal aggregates")
    ts.add_argument("journal")
    tf = tsub.add_parser(
        "diff",
        help="record-by-record decision diff of two journals "
        "(exit 1 on any difference)",
    )
    tf.add_argument("journal")
    tf.add_argument("other")
    tr = tsub.add_parser(
        "replay",
        help="re-execute a journal and diff bindings bitwise "
        "(exit 1 on any diff)",
    )
    tr.add_argument("journal")
    tr.add_argument(
        "--engine",
        default="local",
        help='"local" or a gRPC sidecar target like "localhost:50051"',
    )
    tr.add_argument("--mode", choices=("serial", "pipelined"), default="serial")
    _add_device_flag(tr)
    tr.add_argument(
        "--resident",
        action="store_true",
        help="drive the resident-state delta-upload surface",
    )
    tr.add_argument(
        "--out",
        default=None,
        help="re-record the replayed cycles as a new journal here",
    )
    tr.add_argument(
        "--spans",
        dest="span_path",
        default=None,
        help="re-emit every replayed cycle as Chrome-trace spans under "
        "this directory (post-hoc attribution for a telemetry-off "
        "journal; analyze with `spans report`/`spans diff`)",
    )
    tn = tsub.add_parser(
        "trend",
        help="soak-length leak & drift gate over one journal: windowed "
        "regression slopes for p99 creep, queue-depth runaway, "
        "resident-state growth and delta hit-rate decay (exit 1 on a "
        "regression, 2 on error)",
    )
    tn.add_argument("journal")
    tn.add_argument(
        "--windows", type=int, default=6,
        help="number of equal record slices the journal is cut into",
    )
    tn.add_argument(
        "--threshold-pct", type=float, default=25.0,
        help="relative first-to-last growth a series must show to fail",
    )
    tn.add_argument(
        "--min-ms", type=float, default=0.05,
        help="absolute cycle-latency growth floor (sub-tick jitter "
        "must not fail soaks)",
    )
    pt.set_defaults(fn=cmd_trace)

    pz = sub.add_parser(
        "scenario",
        help="scenario harness: seeded adversarial traffic programs "
        "(sim/scenarios), replay-pinned via the flight recorder",
    )
    zsub = pz.add_subparsers(dest="scenario_cmd", required=True)
    zl = zsub.add_parser("list", help="list registered scenarios")
    zl.set_defaults(fn=cmd_scenario)
    zr = zsub.add_parser(
        "run", help="run one scenario; prints a summary JSON line"
    )
    zr.add_argument("name", help="a registered scenario (see `list`)")
    zr.add_argument("--nodes", type=int, default=64)
    zr.add_argument(
        "--intensity", type=float, default=1.0,
        help="traffic scale factor relative to the node count",
    )
    zr.add_argument("--seed", type=int, default=0)
    _add_device_flag(zr)
    zr.add_argument(
        "--trace", dest="trace_path", default=None,
        help="emit a flight-recorder journal under this directory "
        "(replay-pin with `yoda-tpu trace replay`)",
    )
    zr.add_argument(
        "--spans", dest="span_path", default=None,
        help="emit per-cycle span timelines under this directory "
        "(adversarial programs produce attribution data: analyze with "
        "`yoda-tpu spans report`)",
    )
    zr.add_argument(
        "--pipeline", action="store_true",
        help="drive the pipelined host loop (pipeline_depth=1)",
    )
    zr.add_argument(
        "--resident", action="store_true",
        help="device-resident cluster state (implies --pipeline)",
    )
    zr.add_argument(
        "--gang-off", action="store_true",
        help="disable gang co-scheduling (gang labels ignored)",
    )
    zr.add_argument(
        "--mirror", action="store_true",
        help="streaming state ingestion (snapshot_mirror): the world "
        "drives informer-style events through the event-sourced "
        "snapshot mirror instead of per-cycle rebuilds",
    )
    zr.add_argument(
        "--shared-engine", dest="shared_engine", action="store_true",
        help="fleet-shared device engine (replicated scenarios): ONE "
        "resident engine behind host/engine_pool, replicas' windows "
        "coalesced into one device invocation per round (implies "
        "--pipeline; no-op for replicas=1 scenarios)",
    )
    zr.add_argument(
        "--no-faults", action="store_true",
        help="run a chaos program's traffic WITHOUT its fault plan "
        "(the clean A/B twin of the same seeded run)",
    )
    zr.add_argument(
        "--require-recovery", action="store_true",
        help="exit 1 unless the run ends fully recovered (every "
        "degradation-ladder rung at top, breakers closed) — the "
        "chaos-smoke gate",
    )
    zr.set_defaults(fn=cmd_scenario)

    pw = sub.add_parser(
        "shadow",
        help="shadow-mode serving: tail a live flight-recorder journal "
        "and re-score every cycle through a CANDIDATE config — "
        "decision/latency diffs on a dedicated /metrics exporter, "
        "zero writes to the bind path (the rollout gate)",
    )
    pw.add_argument("journal", help="journal directory to tail")
    pw.add_argument(
        "--candidate-config", default=None,
        help="candidate SchedulerConfig JSON (default: built-in "
        "defaults) — policy/assigner/normalizer/plugins/auction knobs "
        "override the recorded engine options per cycle",
    )
    pw.add_argument(
        "--mode", choices=("serial", "pipelined"), default="serial",
        help="candidate dispatch mode (pipelined = async handle path)",
    )
    pw.add_argument(
        "--follow", action="store_true",
        help="keep tailing across rotations until idle-timeout or "
        "interrupt (without it: one catch-up pass over what exists)",
    )
    pw.add_argument(
        "--poll-interval-s", type=float, default=0.25,
        help="(--follow) sleep between empty polls",
    )
    pw.add_argument(
        "--idle-timeout-s", type=float, default=None,
        help="(--follow) stop after this long with no new records",
    )
    pw.add_argument(
        "--limit", type=int, default=None,
        help="stop after scoring this many records",
    )
    pw.add_argument(
        "--resume-seq", type=int, default=None,
        help="skip records with seq <= this (resume a prior shadow)",
    )
    pw.add_argument(
        "--resume-end", action="store_true",
        help="resume past everything already in the journal (score "
        "only records written after startup)",
    )
    pw.add_argument(
        "--metrics-port", type=int, default=None,
        help="serve the shadow's own /metrics exporter on this port "
        "(0 = ephemeral; the bound port is printed as a JSON line)",
    )
    pw.add_argument("--metrics-host", default="127.0.0.1")
    _add_device_flag(pw)
    pw.add_argument(
        "--spans", dest="span_path", default=None,
        help="emit shadow span timelines (reconstruct/candidate_step/"
        "decision_diff) under this directory",
    )
    pw.add_argument(
        "--max-divergence-ratio", type=float, default=None,
        help="exit 1 when the final bindings-changed / pods-compared "
        "ratio exceeds this (the CI-able rollout gate)",
    )
    pw.set_defaults(fn=cmd_shadow)

    pn = sub.add_parser(
        "spans",
        help="span timelines: merge host + sidecar files, per-stage "
        "budget reports, regression diffs",
    )
    nsub = pn.add_subparsers(dest="spans_cmd", required=True)
    nm = nsub.add_parser(
        "merge",
        help="join host and sidecar span directories on trace id into "
        "one Perfetto-loadable Chrome trace (exit 1 when non-empty "
        "sides share no trace ids)",
    )
    nm.add_argument("host", help="host span directory (--spans)")
    nm.add_argument("sidecar", help="sidecar span directory (--span-path)")
    nm.add_argument("--out", required=True, help="merged trace JSON path")
    nr = nsub.add_parser(
        "report",
        help="per-stage p50/p95/p99 + the cycle budget attribution "
        "table from a span directory, a merged trace, or one span file "
        "(exit 1 when there is nothing to report on)",
    )
    nr.add_argument(
        "source", help="span directory / merged trace JSON / span file"
    )
    nr.add_argument(
        "--trend", action="store_true",
        help="slice ONE soak-length span source into time windows and "
        "gate on monotone p50/p99 drift instead of printing the "
        "budget table (exit 1 on a regression, 2 on error)",
    )
    nr.add_argument(
        "--trend-windows", type=int, default=8,
        help="number of equal time slices for --trend",
    )
    nr.add_argument(
        "--trend-warmup", type=int, default=1,
        help="(--trend) leading non-empty windows to drop as warmup "
        "(JIT compile / cold caches) when enough points remain",
    )
    nr.add_argument(
        "--threshold-pct", type=float, default=25.0,
        help="(--trend) relative growth a series must show to fail",
    )
    nr.add_argument(
        "--min-ms", type=float, default=0.05,
        help="(--trend) absolute growth floor below which a series "
        "never regresses",
    )
    nd = nsub.add_parser(
        "diff",
        help="compare two span sources (or saved reports) per stage; "
        "exit 1 on any p50 regression over the thresholds — the "
        "CI-able perf gate",
    )
    nd.add_argument("baseline", help="span dir / merged trace / report JSON")
    nd.add_argument("candidate", help="span dir / merged trace / report JSON")
    nd.add_argument(
        "more", nargs="*",
        help="(--trend) additional span sources, oldest -> newest",
    )
    nd.add_argument(
        "--trend", action="store_true",
        help="treat baseline/candidate/MORE as a time-ordered series "
        "of soak snapshots and fail on a monotone p50/p99 regression "
        "slope across them (exit 1 on a regression, 2 on error)",
    )
    nd.add_argument(
        "--threshold-pct", type=float, default=25.0,
        help="default per-stage relative p50 regression threshold",
    )
    nd.add_argument(
        "--min-ms", type=float, default=0.05,
        help="absolute p50 growth floor below which a stage never "
        "regresses (sub-tick jitter must not fail builds)",
    )
    nd.add_argument(
        "--stage-threshold", action="append", metavar="STAGE=PCT",
        help="per-stage threshold override (repeatable), e.g. "
        "engine_step=10; use stage name `cycle` for the whole-cycle row",
    )
    pn.set_defaults(fn=cmd_spans)

    pf = sub.add_parser("config", help="print effective config")
    _add_config_flags(pf)
    pf.set_defaults(fn=cmd_config)

    pp = sub.add_parser("policies", help="list policies and plugins")
    pp.set_defaults(fn=cmd_policies)
    return p


def _terminate(signum, frame):
    """SIGTERM -> SystemExit so `finally` blocks run: Kubernetes stops
    pods with SIGTERM, and the serve loops must release the leader Lease
    on the way out (an unreleased lease stalls failover for the full
    lease duration) and close exporters/caches cleanly."""
    raise SystemExit(143)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose >= 2 else
        logging.INFO if args.verbose == 1 else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    try:
        import signal

        signal.signal(signal.SIGTERM, _terminate)
    except ValueError:
        pass  # not the main thread (embedded use): skip
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
