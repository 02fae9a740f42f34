"""The declared protocol state machines (see package docstring).

Each model abstracts one protocol whose invariants previously lived in
comments, with every transition ANCHORED to the code site it abstracts
(anchors.py — lint fails when the code moves). Variables range over
small declared domains and environment churn is budget-bounded, so the
checker exhausts the state space.

Abstraction notes, per model:

- `client-session`: RPCs are atomic transitions (the client holds one
  RPC in flight at a time — bridge/client.py's single async worker);
  concurrency enters through environment transitions (sidecar restart/
  downgrade/upgrade, session eviction, layout churn) interleaving
  between them. Epochs are modeled RELATIVELY: `srv_sess` says whether
  the sidecar's retained resident state is the client's current delta
  base ("base"), someone else's ("stale"), or gone ("none") — which is
  exactly what the epoch comparison decides, without unbounded
  counters. `corrupt` is a ghost variable: it can only become True if a
  row-diff delta derived across a layout change is ever applied (the
  silent-divergence bug class `snapshot_delta`'s None-on-churn contract
  exists to prevent).
- `gang-queue-front` / `gang-queue-native`: four pods (a 2-gang whose
  second member arrives late, two plains), window cap 2, a pipelined
  prefetch slot — the smallest world where "deferred gang straddles a
  prefetched window" can happen. The two variants encode the two
  restore semantics `SchedulingQueue.RESTORES_TO_FRONT` documents and
  `Scheduler._defer_gang` branches on.
- `pipeline-slot`: the 1-deep pipelined driver's in-flight slot,
  speculative pod batch (fresh/stale under informer churn), and the
  optimistic resident commit that a failure path must roll back.
  `last_fail` / `scored_stale` are ghost variables making the two
  failure-path obligations state-visible.
- `replica-bind`: the cross-replica conflict protocol, SHIPPED as
  host/replica.py (the replicated fleet over the partitioned queue):
  two replicas whose queue partitions transiently overlap on one pod,
  binds fenced by the BindTable epoch CAS (first bind wins), the loser
  requeueing via restore_window and dropping on re-pop when the table
  shows the pod bound. Checked BEFORE the scale-out code existed; its
  anchors now bind to the shipped primitives (ReplicaCoordinator.
  pop_window/bind_lose/drop_bound, BindTable.try_bind, and the
  binder's 404/409 arm the conflict raise lands in) — anchor drift
  fails lint, so the model is a proof about the code that runs.
  Extended for the fleet-shared engine (host/engine_pool.py): each
  replica's window now DISPATCHES through the shared pool before it
  can bind, and the pool's resident epoch is modeled RELATIVELY (the
  same abstraction `client-session` uses for `srv_sess`): `pool_base`
  says whether the sidecar retains the pool's current delta base
  ("held") or a flush/crash dropped it ("none"). `stale_delta` is a
  ghost variable: it can only become True if a coalesced dispatch
  ever ships a row-diff delta against a base the sidecar no longer
  holds — the bug class the pool's epoch fence (classify-full on a
  dropped base) exists to prevent.
"""

from __future__ import annotations

import dataclasses

from kubernetes_scheduler_tpu_torch.analysis.model.anchors import Anchor
from kubernetes_scheduler_tpu_torch.analysis.model.checker import (
    Convergence,
    Invariant,
    ProtocolModel,
    Transition,
)

_CLIENT = "kubernetes_scheduler_tpu_torch/bridge/client.py"
_SERVER = "kubernetes_scheduler_tpu_torch/bridge/server.py"
_SCHED = "kubernetes_scheduler_tpu_torch/host/scheduler.py"
_QUEUE = "kubernetes_scheduler_tpu_torch/host/queue.py"
_SNAP = "kubernetes_scheduler_tpu_torch/host/snapshot.py"
_RESIL = "kubernetes_scheduler_tpu_torch/host/resilience.py"
_REPLICA = "kubernetes_scheduler_tpu_torch/host/replica.py"
_POOL = "kubernetes_scheduler_tpu_torch/host/engine_pool.py"
_FAULTS = "kubernetes_scheduler_tpu_torch/sim/faults.py"

# ---- model 1: RemoteEngine client session / sidecar session state --------

_LATCHES = ("l_cache", "l_res", "l_win", "l_gang", "l_fmm")
_ALL_LATCH = frozenset(_LATCHES)


def _probe_effect(s):
    new = "t" if s["build"] == "new" else "f"
    return {l: (new if s[l] == "u" else s[l]) for l in _LATCHES}


def _caches_after_send(s):
    on = s["l_cache"] == "t"
    return {"wire_cache": on, "srv_cache": on}


def _invalidate_effect(s):
    out = {l: "u" for l in _LATCHES}
    out.update(wire_cache=False, cli_base=False, churn=False)
    return out


def client_session_model() -> ProtocolModel:
    t = []
    t.append(Transition(
        name="probe_health",
        process="host",
        guard=lambda s: any(s[l] == "u" for l in _LATCHES),
        effect=_probe_effect,
        reads=frozenset({"build"}) | _ALL_LATCH,
        writes=_ALL_LATCH,
        anchors=(
            Anchor(_CLIENT, "RemoteEngine._probe_capabilities",
                   must_contain=("CAPABILITY_LATCHES",),
                   calls=("health_info",)),
            Anchor(_SERVER, "EngineService.health",
                   must_contain=("CAPABILITY_SWITCHES",)),
        ),
    ))
    t.append(Transition(
        name="rpc_delta_applied",
        process="host",
        guard=lambda s: (
            s["l_res"] == "t" and s["cli_base"] and not s["churn"]
            and s["build"] == "new" and s["srv_sess"] == "base"
        ),
        effect=_caches_after_send,
        reads=frozenset(
            {"l_res", "l_cache", "cli_base", "churn", "build", "srv_sess"}
        ),
        writes=frozenset({"wire_cache", "srv_cache"}),
        anchors=(
            Anchor(_CLIENT, "RemoteEngine._resident_call",
                   must_contain=("resident-epoch-mismatch",)),
            Anchor(_SERVER, "EngineService._resident_snapshot",
                   must_contain=("resident-epoch-mismatch",
                                 "request.resident_epoch")),
        ),
    ))
    t.append(Transition(
        name="rpc_delta_mismatch_full_resend",
        process="host",
        guard=lambda s: (
            s["l_res"] == "t" and s["cli_base"] and not s["churn"]
            and s["build"] == "new" and s["srv_sess"] != "base"
        ),
        effect=lambda s: dict(_caches_after_send(s), srv_sess="base"),
        reads=frozenset(
            {"l_res", "l_cache", "cli_base", "churn", "build", "srv_sess"}
        ),
        writes=frozenset({"srv_sess", "wire_cache", "srv_cache"}),
        anchors=(
            Anchor(_CLIENT, "RemoteEngine._resident_call",
                   must_contain=("build_request(False)",)),
        ),
    ))
    t.append(Transition(
        name="rpc_full_resident",
        process="host",
        guard=lambda s: (
            s["l_res"] == "t" and (not s["cli_base"] or s["churn"])
            and s["build"] == "new"
        ),
        effect=lambda s: dict(
            _caches_after_send(s), srv_sess="base", cli_base=True,
            churn=False,
        ),
        reads=frozenset({"l_res", "l_cache", "cli_base", "churn", "build"}),
        writes=frozenset(
            {"srv_sess", "cli_base", "churn", "wire_cache", "srv_cache"}
        ),
        anchors=(
            Anchor(_SCHED, "Scheduler._derive_resident_delta",
                   must_contain=("snapshot_delta",)),
            Anchor(_CLIENT, "RemoteEngine.schedule_resident",
                   must_contain=("resident_full",)),
        ),
    ))
    t.append(Transition(
        name="rpc_fail_invalidate",
        process="host",
        guard=lambda s: (
            s["build"] == "old" and any(s[l] == "t" for l in _LATCHES)
        ),
        effect=_invalidate_effect,
        reads=frozenset({"build"}) | _ALL_LATCH,
        writes=_ALL_LATCH | frozenset({"wire_cache", "cli_base", "churn"}),
        anchors=(
            Anchor(_CLIENT, "RemoteEngine._invalidate_session",
                   must_contain=("CAPABILITY_LATCHES", "_wire_cache.clear")),
            Anchor(_CLIENT, "RemoteEngine._call_cached",
                   calls=("_invalidate_session",)),
            Anchor(_SCHED, "Scheduler._invalidate_resident",
                   must_contain=("_resident_prev",)),
        ),
    ))
    t.append(Transition(
        name="rpc_cache_miss_full_resend",
        process="host",
        guard=lambda s: (
            s["build"] == "new" and s["l_cache"] == "t"
            and s["wire_cache"] and not s["srv_cache"]
        ),
        effect=lambda s: {"srv_cache": True},
        reads=frozenset({"build", "l_cache", "wire_cache", "srv_cache"}),
        writes=frozenset({"srv_cache"}),
        anchors=(
            Anchor(_CLIENT, "RemoteEngine._call_cached",
                   must_contain=("field-cache-miss",)),
        ),
    ))
    t.append(Transition(
        name="host_flush_resident",
        process="host",
        guard=lambda s: s["cli_base"],
        effect=lambda s: {
            "cli_base": False, "churn": False,
            "srv_sess": "stale" if s["srv_sess"] == "base" else s["srv_sess"],
        },
        reads=frozenset({"cli_base", "srv_sess"}),
        writes=frozenset({"cli_base", "churn", "srv_sess"}),
        anchors=(
            Anchor(_SCHED, "Scheduler._invalidate_resident",
                   must_contain=("_resident_ok",)),
        ),
    ))
    t.append(Transition(
        name="layout_churn",
        process="env",
        guard=lambda s: s["cli_base"] and not s["churn"],
        effect=lambda s: {"churn": True},
        reads=frozenset({"cli_base", "churn"}),
        writes=frozenset({"churn"}),
        anchors=(
            Anchor(_SNAP, "snapshot_delta", must_contain=("return None",)),
        ),
    ))
    t.append(Transition(
        name="sidecar_restart",
        process="env",
        guard=lambda s: s["env_budget"] > 0,
        effect=lambda s: {
            "srv_sess": "none", "srv_cache": False,
            "env_budget": s["env_budget"] - 1,
        },
        reads=frozenset({"env_budget"}),
        writes=frozenset({"srv_sess", "srv_cache", "env_budget"}),
        anchors=(
            Anchor(_SERVER, "EngineService._session",
                   must_contain=("_MAX_CACHE_SESSIONS",)),
        ),
    ))
    t.append(Transition(
        name="sidecar_downgrade",
        process="env",
        guard=lambda s: s["env_budget"] > 0 and s["build"] == "new",
        effect=lambda s: {
            "build": "old", "srv_sess": "none", "srv_cache": False,
            "env_budget": s["env_budget"] - 1,
        },
        reads=frozenset({"env_budget", "build"}),
        writes=frozenset({"build", "srv_sess", "srv_cache", "env_budget"}),
        anchors=(
            Anchor(_SERVER, "EngineService.health",
                   must_contain=("CAPABILITY_SWITCHES",)),
        ),
    ))
    t.append(Transition(
        name="sidecar_upgrade",
        process="env",
        guard=lambda s: s["env_budget"] > 0 and s["build"] == "old",
        effect=lambda s: {
            "build": "new", "srv_sess": "none", "srv_cache": False,
            "env_budget": s["env_budget"] - 1,
        },
        reads=frozenset({"env_budget", "build"}),
        writes=frozenset({"build", "srv_sess", "srv_cache", "env_budget"}),
    ))
    return ProtocolModel(
        name="client-session",
        description=(
            "RemoteEngine session protocol: wire field cache + the five "
            "capability latches + resident delta base vs the sidecar's "
            "session-keyed state, under restart/downgrade/eviction/"
            "layout churn"
        ),
        init={
            "build": "new", "srv_sess": "none", "srv_cache": False,
            "l_cache": "u", "l_res": "u", "l_win": "u", "l_gang": "u",
            "l_fmm": "u",
            "wire_cache": False, "cli_base": False, "churn": False,
            "corrupt": False, "env_budget": 2,
        },
        transitions=tuple(t),
        invariants=(
            Invariant(
                "latches-resolved-together",
                lambda s: len({s[l] == "u" for l in _LATCHES}) == 1,
                "capability latches must be probed and invalidated as a "
                "set — a partially-unknown latch set means some failure "
                "path reset one latch but not the others (the "
                "mid-stream-downgrade class)",
            ),
            Invariant(
                "no-marker-without-latch",
                lambda s: not s["wire_cache"] or s["l_cache"] == "t",
                "the client may only reference server-cached tensors "
                "while the field-cache latch is affirmatively resolved — "
                "an invalidation that reset the latch but kept the wire "
                "cache would send markers an unknown sidecar cannot "
                "resolve",
            ),
            Invariant(
                "no-delta-base-without-latch",
                lambda s: not s["cli_base"] or s["l_res"] == "t",
                "the host may only hold a resident delta base while the "
                "resident capability latch is affirmatively resolved "
                "(failure paths invalidate both together)",
            ),
            Invariant(
                "resident-state-faithful",
                lambda s: not s["corrupt"],
                "a row-diff delta derived across a layout change must "
                "never be applied — snapshot_delta's None-on-churn "
                "contract (silent binding divergence otherwise)",
            ),
        ),
        convergences=(
            Convergence(
                "epoch-desync-converges",
                trigger=lambda s: (
                    s["l_res"] == "t" and s["cli_base"]
                    and s["srv_sess"] == "stale"
                ),
                goal=lambda s: s["srv_sess"] == "base" or s["l_res"] != "t",
                description=(
                    "an epoch desync (sidecar retaining someone else's "
                    "base) must always converge to a full resend or a "
                    "session invalidation — never loop on rejected deltas"
                ),
            ),
            Convergence(
                "downgrade-relearned",
                trigger=lambda s: (
                    s["build"] == "old"
                    and any(s[l] == "t" for l in _LATCHES)
                ),
                goal=lambda s: (
                    s["build"] == "new"
                    or all(s[l] != "t" for l in _LATCHES)
                ),
                description=(
                    "after a mid-stream downgrade the client must stop "
                    "trusting the dead sidecar's advertisement: every "
                    "path re-learns the capabilities (or the sidecar "
                    "comes back new) — a latch left True forever retries "
                    "unparseable sends every cycle"
                ),
            ),
        ),
    )


# ---- models 2a/2b: gang deferral over the two queue restore semantics ----

_GANG = ("g1", "g2")
_GANG_SIZE = 2
_MAX_DEFERS = 1
_WINDOW_CAP = 2


def _gang_members(s, window):
    if s["split"]:
        return []
    return [p for p in window if p in _GANG]


def _resolve_effect(s, *, front: bool, defer_to_back: bool = False):
    window = s["window"]
    gang = _gang_members(s, window)
    plains = [p for p in window if p not in gang]
    updates = {"window": (), "just_deferred": False}
    bound = list(s["bound"])
    if gang and len(gang) < _GANG_SIZE:
        bound.extend(plains)
        if s["defers"] >= _MAX_DEFERS:
            # budget exhausted: split policy — members become
            # individuals and requeue at ordinary (back) cadence
            updates["split"] = True
            updates["queue"] = s["queue"] + tuple(gang)
        else:
            updates["defers"] = s["defers"] + 1
            updates["just_deferred"] = True
            if front and not defer_to_back:
                # front-restoring queue: hand the prefetched window
                # back FIRST, then the gang — the gang leads the next
                # pop exactly as the serial driver would pop it
                updates["queue"] = tuple(gang) + s["prefetch"] + s["queue"]
                updates["prefetch"] = ()
            elif front and defer_to_back:
                # the seeded mutant: members restored to the BACK of a
                # front-restoring queue
                updates["queue"] = s["prefetch"] + s["queue"] + tuple(gang)
                updates["prefetch"] = ()
            else:
                # back-restoring queue (native heap): the prefetch is
                # KEPT and the gang re-enters at the back
                updates["queue"] = s["queue"] + tuple(gang)
    else:
        bound.extend(window)
    updates["bound"] = tuple(sorted(bound))
    return updates


def _conservation_ok(s):
    have = sorted(s["queue"] + s["window"] + s["prefetch"] + s["bound"])
    want = sorted(("g1", "p1", "p2") + (("g2",) if s["arrived2"] else ()))
    return have == want


def gang_queue_model(*, front: bool) -> ProtocolModel:
    name = "gang-queue-front" if front else "gang-queue-native"
    restore_anchor = (
        Anchor(_QUEUE, "SchedulingQueue.restore_window",
               must_contain=("_front_floor",))
        if front
        else Anchor(_QUEUE, "NativeBackedQueue.restore_window",
                    calls=("push",))
    )
    t = (
        Transition(
            name="pop_window",
            process="driver",
            guard=lambda s: s["window"] == () and (
                s["prefetch"] != () or s["queue"] != ()
            ),
            effect=lambda s: (
                {"window": s["prefetch"], "prefetch": (),
                 "just_deferred": False}
                if s["prefetch"] != ()
                else {"window": s["queue"][:_WINDOW_CAP],
                      "queue": s["queue"][_WINDOW_CAP:],
                      "just_deferred": False}
            ),
            reads=frozenset({"window", "prefetch", "queue"}),
            writes=frozenset({"window", "prefetch", "queue",
                              "just_deferred"}),
            anchors=(
                Anchor(_QUEUE, "SchedulingQueue.pop_window",
                       calls=("_drain_backoff",)),
                Anchor(_SCHED, "Scheduler._take_prefetched"),
            ),
        ),
        Transition(
            name="prefetch_window",
            process="driver",
            guard=lambda s: (
                s["window"] != () and s["prefetch"] == ()
                and s["queue"] != ()
            ),
            effect=lambda s: {
                "prefetch": s["queue"][:_WINDOW_CAP],
                "queue": s["queue"][_WINDOW_CAP:],
            },
            reads=frozenset({"window", "prefetch", "queue"}),
            writes=frozenset({"prefetch", "queue"}),
            anchors=(
                Anchor(_SCHED, "Scheduler._prefetch_next",
                       must_contain=("pop_window",)),
            ),
        ),
        Transition(
            name="resolve_window",
            process="driver",
            guard=lambda s: s["window"] != (),
            effect=lambda s, front=front: _resolve_effect(s, front=front),
            reads=frozenset(
                {"window", "queue", "prefetch", "defers", "split", "bound"}
            ),
            writes=frozenset(
                {"window", "queue", "prefetch", "defers", "split", "bound",
                 "just_deferred"}
            ),
            anchors=(
                Anchor(_SCHED, "Scheduler._resolve_gangs",
                       must_contain=("mask_partial_gangs_np",),
                       calls=("_defer_gang",)),
                Anchor(_SCHED, "Scheduler._defer_gang",
                       must_contain=("RESTORES_TO_FRONT",
                                     "gang_defer_policy"),
                       calls=("restore_window",)),
                restore_anchor,
            ),
        ),
        Transition(
            name="arrive_g2",
            process="arrivals",
            guard=lambda s: not s["arrived2"],
            effect=lambda s: {
                "queue": s["queue"] + ("g2",), "arrived2": True,
            },
            reads=frozenset({"queue", "arrived2"}),
            writes=frozenset({"queue", "arrived2"}),
            anchors=(Anchor(_QUEUE, "SchedulingQueue.push"),),
        ),
    )
    invariants = [
        Invariant(
            "gang-never-partially-admitted",
            lambda s: s["split"] or not (
                0 < sum(1 for p in _GANG if p in s["bound"]) < _GANG_SIZE
            ),
            "an unsplit gang binds whole or not at all — a deferred "
            "gang is restored whole or split, never partially admitted",
        ),
        Invariant(
            "no-pod-lost-or-duplicated",
            _conservation_ok,
            "every arrived pod is in exactly one of queue/window/"
            "prefetch/bound — deferral must neither drop nor duplicate "
            "a popped pod",
        ),
    ]
    if front:
        invariants.append(Invariant(
            "deferred-gang-leads-next-pop",
            lambda s: not s["just_deferred"] or (
                s["queue"] != () and s["queue"][0] in _GANG
            ),
            "on a front-restoring queue an in-budget deferral hands the "
            "prefetched window back first and the gang second, so the "
            "gang leads the next pop (serial/pipelined pop-order "
            "parity; Scheduler._defer_gang)",
        ))
    return ProtocolModel(
        name=name,
        description=(
            "gang all-or-nothing deferral against a "
            f"{'front' if front else 'back'}-restoring queue, with a "
            "pipelined prefetch slot and a late-arriving member"
        ),
        init={
            "queue": ("g1", "p1", "p2"), "window": (), "prefetch": (),
            "arrived2": False, "defers": 0, "split": False, "bound": (),
            "just_deferred": False,
        },
        transitions=t,
        invariants=tuple(invariants),
        convergences=(
            Convergence(
                "every-pod-settles",
                trigger=lambda s: True,
                goal=lambda s: (
                    s["arrived2"] and s["queue"] == ()
                    and s["window"] == () and s["prefetch"] == ()
                    and len(s["bound"]) == 4
                ),
                description=(
                    "deferral is bounded: every pod (gang members "
                    "included, split or admitted) eventually binds — no "
                    "defer/restore livelock"
                ),
            ),
        ),
    )


# ---- model 3: the pipelined driver's in-flight slot ----------------------


def pipeline_slot_model() -> ProtocolModel:
    t = (
        Transition(
            name="dispatch",
            process="driver",
            guard=lambda s: s["inflight"] == 0,
            effect=lambda s: {
                "inflight": 1,
                # a stale speculative batch is REBUILT, never scored
                "spec": "none",
                # optimistic resident commit: the dispatched snapshot
                # becomes the next delta base
                "resident_ok": True,
                "last_fail": False,
            },
            reads=frozenset({"inflight", "spec"}),
            writes=frozenset({"inflight", "spec", "resident_ok",
                              "last_fail"}),
            anchors=(
                Anchor(_SCHED, "Scheduler._dispatch_window",
                       must_contain=("_layout_fingerprint",)),
                Anchor(_SCHED, "Scheduler._dispatch_resident",
                       calls=("_commit_resident",)),
            ),
        ),
        Transition(
            name="prefetch_spec_batch",
            process="driver",
            guard=lambda s: s["inflight"] == 1 and s["spec"] == "none",
            effect=lambda s: {"spec": "fresh"},
            reads=frozenset({"inflight", "spec"}),
            writes=frozenset({"spec"}),
            anchors=(
                Anchor(_SCHED, "Scheduler._prefetch_next",
                       must_contain=("_spec_batch",)),
            ),
        ),
        Transition(
            name="complete_ok",
            process="driver",
            guard=lambda s: s["inflight"] == 1,
            effect=lambda s: {"inflight": 0},
            reads=frozenset({"inflight"}),
            writes=frozenset({"inflight"}),
            anchors=(Anchor(_SCHED, "Scheduler._complete_window"),),
        ),
        Transition(
            name="complete_fail",
            process="driver",
            guard=lambda s: s["inflight"] == 1 and s["fail_budget"] > 0,
            effect=lambda s: {
                "inflight": 0,
                # the failure path must BOTH drop speculative state and
                # roll the optimistic resident commit back
                "spec": "none",
                "resident_ok": False,
                "last_fail": True,
                "fail_budget": s["fail_budget"] - 1,
            },
            reads=frozenset({"inflight", "fail_budget"}),
            writes=frozenset({"inflight", "spec", "resident_ok",
                              "last_fail", "fail_budget"}),
            anchors=(
                # the failure arm moved into the split-phase completion
                # when run_cycle_split/complete grew the dispatch seam
                # (fleet-shared engine PR); the obligations are the same
                Anchor(_SCHED, "Scheduler._complete_cycle_split",
                       must_contain=("_invalidate_resident",
                                     "_discard_speculative")),
            ),
        ),
        Transition(
            name="informer_churn",
            process="env",
            guard=lambda s: s["spec"] == "fresh" and s["churn_budget"] > 0,
            effect=lambda s: {
                "spec": "stale", "churn_budget": s["churn_budget"] - 1,
            },
            reads=frozenset({"spec", "churn_budget"}),
            writes=frozenset({"spec", "churn_budget"}),
            anchors=(
                Anchor(_SCHED, "Scheduler._layout_fingerprint",
                       must_contain=("selectors",)),
            ),
        ),
    )
    return ProtocolModel(
        name="pipeline-slot",
        description=(
            "the 1-deep pipelined driver: in-flight slot, speculative "
            "pod batch under informer churn, optimistic resident commit "
            "vs the failure path"
        ),
        init={
            "inflight": 0, "spec": "none", "resident_ok": False,
            "last_fail": False, "scored_stale": False,
            "fail_budget": 2, "churn_budget": 2,
        },
        transitions=t,
        invariants=(
            Invariant(
                "single-rpc-in-flight",
                lambda s: s["inflight"] <= 1,
                "the pipelined driver keeps at most ONE engine call in "
                "flight (bridge client: one async worker)",
            ),
            Invariant(
                "failure-invalidates-resident",
                lambda s: not s["last_fail"] or not s["resident_ok"],
                "a failed cycle must roll back the optimistic resident "
                "commit — the next dispatch uploads in full, never a "
                "delta against a base the engine may not hold",
            ),
            Invariant(
                "stale-spec-batch-never-scored",
                lambda s: not s["scored_stale"],
                "a speculative pod batch whose layout fingerprint no "
                "longer matches is rebuilt, never dispatched",
            ),
        ),
    )


# ---- model 4: 2-replica cross-partition bind conflict (host/replica.py) --


def _bind_win(r):
    def guard(s):
        return (
            s[f"r{r}"] == "holds" and s[f"disp_{r}"]
            and s["pod_bound"] == ""
            and s[f"seen_{r}"] == s["pod_epoch"]
        )

    def effect(s):
        return {
            "pod_bound": r, "pod_epoch": s["pod_epoch"] + 1,
            f"r{r}": "idle", f"disp_{r}": False,
        }

    return guard, effect


def _bind_lose(r):
    def guard(s):
        return s[f"r{r}"] == "holds" and s[f"disp_{r}"] and not (
            s["pod_bound"] == "" and s[f"seen_{r}"] == s["pod_epoch"]
        )

    def effect(s):
        # first bind wins; the loser requeues its copy via
        # restore_window and retries from the queue
        return {f"r{r}": "idle", f"avail_{r}": True, f"disp_{r}": False}

    return guard, effect


def _dispatch_effect(s, r, *, fenced: bool = True):
    """One coalesced dispatch through the shared pool for replica
    `r`'s held window. With the shipped fence, a row-diff delta ships
    ONLY while the sidecar retains the pool's current base
    (`_classify` returns "full" on a dropped base); either way the
    dispatch re-establishes the base at the advanced epoch. The
    mutant harness flips `fenced` to ship the delta blindly."""
    ships_delta = s["pool_base"] == "held" if fenced else True
    return {
        f"disp_{r}": True,
        "pool_base": "held",
        "stale_delta": s["stale_delta"]
        or (ships_delta and s["pool_base"] != "held"),
    }


def replica_bind_model() -> ProtocolModel:
    t = []
    for r in ("a", "b"):
        wg, we = _bind_win(r)
        lg, le = _bind_lose(r)
        t.extend([
            Transition(
                name=f"pop_{r}",
                process=f"replica_{r}",
                guard=lambda s, r=r: (
                    s[f"avail_{r}"] and s[f"r{r}"] == "idle"
                    and s["pod_bound"] == ""
                ),
                effect=lambda s, r=r: {
                    f"r{r}": "holds", f"avail_{r}": False,
                    f"seen_{r}": s["pod_epoch"],
                },
                reads=frozenset({f"avail_{r}", f"r{r}", "pod_bound",
                                 "pod_epoch"}),
                writes=frozenset({f"r{r}", f"avail_{r}", f"seen_{r}"}),
                anchors=(
                    # the replica's partition pop: filters table-bound
                    # pods (drop_bound) and records the epoch each
                    # surviving pod was seen at — the fence operand
                    Anchor(_REPLICA, "ReplicaCoordinator.pop_window",
                           must_contain=("epoch",),
                           calls=("pop_window",)),
                ),
            ),
            Transition(
                name=f"dispatch_{r}",
                process=f"replica_{r}",
                guard=lambda s, r=r: (
                    s[f"r{r}"] == "holds" and not s[f"disp_{r}"]
                ),
                effect=lambda s, r=r: _dispatch_effect(s, r),
                reads=frozenset({f"r{r}", f"disp_{r}", "pool_base",
                                 "stale_delta"}),
                writes=frozenset({f"disp_{r}", "pool_base",
                                  "stale_delta"}),
                anchors=(
                    # the executor drains every queued replica window
                    # into one fused dispatch; the base delta is
                    # classified against the pool's retained copy —
                    # a dropped base (flush raced) classifies "full"
                    Anchor(_POOL, "SharedEnginePool._settle",
                           must_contain=("self._executing = True",)),
                    Anchor(_POOL, "SharedEnginePool._execute_group",
                           must_contain=(
                               "self._classify(self._prev, base)",
                           ),
                           calls=("snapshot_delta",)),
                    Anchor(_POOL, "SharedEnginePool._classify",
                           must_contain=("prev is None",)),
                ),
            ),
            Transition(
                name=f"bind_win_{r}",
                process=f"replica_{r}",
                guard=wg,
                effect=we,
                reads=frozenset({f"r{r}", f"disp_{r}", "pod_bound",
                                 f"seen_{r}", "pod_epoch"}),
                writes=frozenset({"pod_bound", "pod_epoch", f"r{r}",
                                  f"disp_{r}"}),
                anchors=(
                    # THE CAS: unbound + current epoch, or rejected;
                    # success installs the winner and advances the epoch
                    Anchor(_REPLICA, "BindTable.try_bind",
                           must_contain=("seen_epoch != rec[0]",
                                         "rec[0] += 1")),
                    # the loser's raise lands in the binder's existing
                    # first-write-wins 409 arm (drop, never requeue)
                    Anchor(_SCHED, "Scheduler._bind",
                           must_contain=("404, 409",)),
                ),
            ),
            Transition(
                name=f"bind_lose_{r}",
                process=f"replica_{r}",
                guard=lg,
                effect=le,
                reads=frozenset({f"r{r}", f"disp_{r}", "pod_bound",
                                 f"seen_{r}", "pod_epoch"}),
                writes=frozenset({f"r{r}", f"avail_{r}", f"disp_{r}"}),
                anchors=(
                    Anchor(_REPLICA, "ReplicaCoordinator.bind_lose",
                           calls=("restore_window",)),
                    # the requeue preserves per-partition front-restore
                    # semantics — the same machinery gang deferral uses
                    Anchor(_QUEUE, "SchedulingQueue.restore_window",
                           must_contain=("_front_floor",)),
                ),
            ),
            Transition(
                name=f"drop_bound_{r}",
                process=f"replica_{r}",
                guard=lambda s, r=r: (
                    s[f"avail_{r}"] and s[f"r{r}"] == "idle"
                    and s["pod_bound"] != ""
                ),
                effect=lambda s, r=r: {f"avail_{r}": False},
                reads=frozenset({f"avail_{r}", f"r{r}", "pod_bound"}),
                writes=frozenset({f"avail_{r}"}),
                anchors=(
                    Anchor(_REPLICA, "ReplicaCoordinator.drop_bound",
                           calls=("mark_scheduled",)),
                ),
            ),
        ])
    t.append(Transition(
        name="engine_flush",
        process="env",
        guard=lambda s: s["flush_budget"] > 0 and s["pool_base"] == "held",
        effect=lambda s: {
            "pool_base": "none", "flush_budget": s["flush_budget"] - 1,
        },
        reads=frozenset({"pool_base", "flush_budget"}),
        writes=frozenset({"pool_base", "flush_budget"}),
        anchors=(
            # sidecar crash mid-batch (_fail fans the error out and
            # drops the base) and external invalidation both leave the
            # pool baseless — the next dispatch MUST re-sync full
            Anchor(_POOL, "SharedEnginePool._fail",
                   must_contain=("self._prev = None",)),
            Anchor(_POOL, "SharedEnginePool.invalidate",
                   must_contain=("self._prev = None",)),
        ),
    ))
    return ProtocolModel(
        name="replica-bind",
        description=(
            "horizontal scale-out conflict protocol (host/replica.py + "
            "host/engine_pool.py): two scheduler replicas transiently "
            "share one pod (partition handoff overlap) and dispatch "
            "through ONE fleet-shared engine; binds are fenced by the "
            "BindTable epoch CAS, first bind wins, the loser requeues "
            "via restore_window and drops on re-pop once the table "
            "shows the pod bound; the shared resident base is fenced by "
            "the pool epoch — a flushed base re-syncs full, never a "
            "blind delta"
        ),
        init={
            "pod_bound": "", "pod_epoch": 0,
            "ra": "idle", "rb": "idle",
            "avail_a": True, "avail_b": True,
            "seen_a": 0, "seen_b": 0,
            "disp_a": False, "disp_b": False,
            "pool_base": "none", "flush_budget": 2,
            "double_bound": False, "stale_delta": False,
        },
        transitions=tuple(t),
        invariants=(
            Invariant(
                "no-double-bind",
                lambda s: not s["double_bound"],
                "a pod is bound by at most one replica — the epoch CAS "
                "(first bind wins) must fence every bind",
            ),
            Invariant(
                "bound-pod-never-re-popped",
                lambda s: not (
                    s["pod_bound"] != "" and (
                        (s["ra"] == "holds" and s["seen_a"] >= s["pod_epoch"])
                        or (s["rb"] == "holds"
                            and s["seen_b"] >= s["pod_epoch"])
                    )
                ),
                "a replica holding the pod after someone bound it must "
                "hold a STALE epoch — its bind attempt is then fenced "
                "off by the CAS",
            ),
            Invariant(
                "shared-delta-fenced",
                lambda s: not s["stale_delta"],
                "a coalesced dispatch ships a row-diff delta only while "
                "the sidecar retains the pool's current resident base — "
                "a replica that raced a flush re-syncs with a fenced "
                "full upload, never a blind delta against state the "
                "engine no longer holds (SharedEnginePool._classify)",
            ),
        ),
        convergences=(
            Convergence(
                "conflict-resolves",
                trigger=lambda s: s["ra"] == "holds" and s["rb"] == "holds",
                goal=lambda s: (
                    s["pod_bound"] != "" and s["ra"] == "idle"
                    and s["rb"] == "idle" and not s["avail_a"]
                    and not s["avail_b"]
                ),
                description=(
                    "when both replicas hold the pod, exactly one bind "
                    "wins and the loser's requeued copy drains — no "
                    "requeue livelock, no stuck copies"
                ),
            ),
        ),
    )


# ---- model 5: the degradation ladder + circuit breaker -------------------
#
# Abstracts host/resilience.py as wired by host/scheduler.py: one
# subsystem's rung (0 = top, abstract depth 3 so a rung SKIP is
# expressible), the probe-before-promote recovery discipline, and the
# engine circuit breaker (closed/open/half-open, threshold 2) whose
# open state must imply a degraded rung (Scheduler._on_breaker_transition
# demotes when the breaker opens). Faults are budget-bounded environment
# churn (sim/faults.FaultInjector windows). Ghost variables: `skipped`
# can only become True if a demote ever moves more than one rung at a
# time; `unprobed_climb` only if a promote fires without a recorded
# probe — the two silent-recovery bug classes the ladder exists to
# forbid.

_LADDER_BOTTOM = 2
_BRK_THRESHOLD = 2


def degradation_ladder_model() -> ProtocolModel:
    def fail_effect(s):
        new_rung = min(s["rung"] + 1, _LADDER_BOTTOM)
        fails = min(s["fails"] + 1, _BRK_THRESHOLD)
        opens = s["breaker"] == "half" or fails >= _BRK_THRESHOLD
        return {
            "fails": fails,
            "breaker": "open" if opens else s["breaker"],
            "rung": new_rung,
            "probed": False,
            "skipped": s["skipped"] or (new_rung - s["rung"] > 1),
        }

    def recover_effect(s):
        return {
            "rung": s["rung"] - 1,
            "probed": False,
            "fails": 0,
            "breaker": "closed" if s["breaker"] == "half" else s["breaker"],
            "unprobed_climb": s["unprobed_climb"] or not s["probed"],
        }

    t = (
        Transition(
            name="attempt_fail",
            process="host",
            guard=lambda s: s["fault"] and s["breaker"] != "open",
            effect=fail_effect,
            reads=frozenset(
                {"fault", "breaker", "fails", "rung", "skipped", "probed"}
            ),
            writes=frozenset(
                {"fails", "breaker", "rung", "probed", "skipped"}
            ),
            anchors=(
                Anchor(_SCHED, "Scheduler._engine_failure",
                       calls=("record_failure", "demote")),
                Anchor(_RESIL, "CircuitBreaker.record_failure",
                       must_contain=("OPEN",)),
                Anchor(_RESIL, "DegradationLadder.demote",
                       must_contain=("d + 1",)),
                Anchor(_SCHED, "Scheduler._on_breaker_transition",
                       calls=("demote",)),
            ),
        ),
        Transition(
            name="probe",
            process="host",
            guard=lambda s: (
                s["rung"] > 0 and not s["probed"] and s["breaker"] != "open"
            ),
            effect=lambda s: {"probed": True},
            reads=frozenset({"rung", "probed", "breaker"}),
            writes=frozenset({"probed"}),
            anchors=(
                Anchor(_RESIL, "DegradationLadder.probe",
                       must_contain=("_probed",)),
                Anchor(_SCHED, "Scheduler._ladder_cycle_end",
                       calls=("probe", "promote")),
            ),
        ),
        Transition(
            name="recover",
            process="host",
            guard=lambda s: (
                s["rung"] > 0 and s["probed"] and not s["fault"]
                and s["breaker"] != "open"
            ),
            effect=recover_effect,
            reads=frozenset(
                {"rung", "probed", "fault", "breaker", "fails",
                 "unprobed_climb"}
            ),
            writes=frozenset(
                {"rung", "probed", "fails", "breaker", "unprobed_climb"}
            ),
            anchors=(
                Anchor(_RESIL, "DegradationLadder.promote",
                       must_contain=("_probed",)),
                Anchor(_RESIL, "CircuitBreaker.record_success"),
            ),
        ),
        Transition(
            name="half_open",
            process="env",
            guard=lambda s: s["breaker"] == "open",
            effect=lambda s: {"breaker": "half"},
            reads=frozenset({"breaker"}),
            writes=frozenset({"breaker"}),
            anchors=(
                Anchor(_RESIL, "CircuitBreaker.allow",
                       must_contain=("HALF_OPEN",)),
            ),
        ),
        Transition(
            name="fault_hit",
            process="env",
            guard=lambda s: not s["fault"] and s["fault_budget"] > 0,
            effect=lambda s: {
                "fault": True, "fault_budget": s["fault_budget"] - 1,
            },
            reads=frozenset({"fault", "fault_budget"}),
            writes=frozenset({"fault", "fault_budget"}),
            anchors=(
                Anchor(_FAULTS, "FaultInjector.check",
                       must_contain=("active",)),
            ),
        ),
        Transition(
            name="fault_clear",
            process="env",
            guard=lambda s: s["fault"],
            effect=lambda s: {"fault": False},
            reads=frozenset({"fault"}),
            writes=frozenset({"fault"}),
            anchors=(
                Anchor(_FAULTS, "FaultInjector.quiesced",
                       must_contain=("last_end",)),
            ),
        ),
    )
    return ProtocolModel(
        name="degradation-ladder",
        description=(
            "the degradation-ladder state machine + engine circuit "
            "breaker under budget-bounded faults: one-rung demotes with "
            "recorded reasons, probe-before-promote recovery, and the "
            "breaker-open-implies-degraded coupling"
        ),
        init={
            "rung": 0, "probed": False, "breaker": "closed", "fails": 0,
            "fault": False, "fault_budget": 2,
            "skipped": False, "unprobed_climb": False,
        },
        transitions=t,
        invariants=(
            Invariant(
                "never-skips-a-rung",
                lambda s: not s["skipped"],
                "every demote moves exactly ONE rung with a recorded "
                "reason — a multi-rung drop is a silent skip the event "
                "log (and operators) never see",
            ),
            Invariant(
                "recovery-re-probes",
                lambda s: not s["unprobed_climb"],
                "a subsystem may only climb a rung after its degraded "
                "path was explicitly re-probed — optimistic un-probed "
                "promotion re-enters the failure it degraded away from",
            ),
            Invariant(
                "breaker-open-implies-degraded",
                lambda s: s["breaker"] == "closed" or s["rung"] >= 1,
                "an open (or probing half-open) engine breaker means "
                "the engine subsystem is NOT at its top rung — the "
                "ladder and the breaker must never disagree about an "
                "outage",
            ),
        ),
        convergences=(
            Convergence(
                "outage-recovers",
                trigger=lambda s: (
                    s["rung"] > 0 and not s["fault"]
                    and s["fault_budget"] == 0
                ),
                goal=lambda s: s["rung"] == 0 and s["breaker"] == "closed",
                description=(
                    "once the faults stop, every path climbs back to "
                    "the top rung with the breaker closed — no probe/"
                    "demote livelock, no rung stuck degraded forever"
                ),
            ),
        ),
    )


# ---- registry ------------------------------------------------------------


def build_models() -> tuple[ProtocolModel, ...]:
    """Fresh instances of every shipped model, in checking order."""
    return (
        client_session_model(),
        gang_queue_model(front=True),
        gang_queue_model(front=False),
        pipeline_slot_model(),
        replica_bind_model(),
        degradation_ladder_model(),
    )


def replace_transition(model: ProtocolModel, name: str, new) -> ProtocolModel:
    """A copy of `model` with transition `name` swapped for `new` —
    the mutation harness's primitive."""
    if not any(t.name == name for t in model.transitions):
        raise KeyError(f"{model.name} has no transition `{name}`")
    return dataclasses.replace(
        model,
        transitions=tuple(
            new if t.name == name else t for t in model.transitions
        ),
    )
