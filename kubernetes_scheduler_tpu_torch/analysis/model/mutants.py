"""The mutation harness: seeded protocol-bug reintroductions.

A model checker that has never caught anything is an assertion, not a
tool. Each mutant below re-introduces a real (or realistic) protocol
bug class into one model — the mid-stream-downgrade bug among
them — and the checker MUST report at least one violation with a
rendered counterexample schedule for every one of them. The model CLI
(and the lint layer) runs the harness on every full lint;
tests/test_torch_protocol_models.py asserts each mutant one by one, so
a checker regression that silently blinds one invariant fails by name.

Every mutant is a pure transformation of a fresh model instance
(protocols.replace_transition) — the shipped models are never mutated
in place.
"""

from __future__ import annotations

import dataclasses

from kubernetes_scheduler_tpu_torch.analysis.model import protocols
from kubernetes_scheduler_tpu_torch.analysis.model.checker import (
    ProtocolModel,
    Transition,
    check_model,
)
from kubernetes_scheduler_tpu_torch.analysis.model.protocols import (
    _ALL_LATCH,
    _LATCHES,
    replace_transition,
)


def _swap(model: ProtocolModel, name: str, **overrides) -> ProtocolModel:
    old = next(t for t in model.transitions if t.name == name)
    return replace_transition(
        model, name, dataclasses.replace(old, **overrides)
    )


# ---- client-session mutants ----------------------------------------------


def mutant_invalidate_keeps_latches() -> ProtocolModel:
    """THE MID-STREAM-DOWNGRADE BUG: a failed send resets the wire field cache but
    keeps the capability latches trusting the dead sidecar's
    advertisement — the client retries unparseable sends forever
    (caught as a `downgrade-relearned` livelock)."""
    m = protocols.client_session_model()
    return _swap(
        m, "rpc_fail_invalidate",
        effect=lambda s: {
            "wire_cache": False, "cli_base": False, "churn": False,
        },
        writes=frozenset({"wire_cache", "cli_base", "churn"}),
    )


def mutant_invalidate_keeps_wire_cache() -> ProtocolModel:
    """The dual of the mid-stream-downgrade bug: the latches reset but the wire cache
    survives invalidation, so the next send references cached tensors
    on a sidecar whose capability is unknown (caught by the
    `no-marker-without-latch` invariant)."""
    m = protocols.client_session_model()
    return _swap(
        m, "rpc_fail_invalidate",
        effect=lambda s: dict(
            {l: "u" for l in _LATCHES},
            cli_base=False, churn=False,
        ),
        writes=_ALL_LATCH | frozenset({"cli_base", "churn"}),
    )


def mutant_partial_probe() -> ProtocolModel:
    """A probe that resolves only the field-cache latch (a new
    capability bit wired into Health but not into the shared probe) —
    the latch set desyncs (caught by `latches-resolved-together`)."""
    m = protocols.client_session_model()
    return _swap(
        m, "probe_health",
        effect=lambda s: {
            "l_cache": ("t" if s["build"] == "new" else "f")
            if s["l_cache"] == "u" else s["l_cache"],
        },
        writes=frozenset({"l_cache"}),
    )


def mutant_delta_across_layout_churn() -> ProtocolModel:
    """Skip the flush-to-full on layout churn: a row-diff delta derived
    across a layout change ships and applies — silent resident-state
    divergence (caught by `resident-state-faithful`)."""
    m = protocols.client_session_model()
    old = next(
        t for t in m.transitions if t.name == "rpc_delta_applied"
    )
    return replace_transition(
        m, "rpc_delta_applied",
        dataclasses.replace(
            old,
            guard=lambda s: (
                s["l_res"] == "t" and s["cli_base"]
                and s["build"] == "new" and s["srv_sess"] == "base"
            ),
            effect=lambda s: dict(
                protocols._caches_after_send(s),
                corrupt=s["corrupt"] or s["churn"],
            ),
            reads=old.reads | frozenset({"corrupt"}),
            writes=old.writes | frozenset({"corrupt"}),
        ),
    )


# ---- queue mutant --------------------------------------------------------


def mutant_defer_restores_to_back() -> ProtocolModel:
    """Restore a deferred gang to the BACK of the front-restoring
    Python queue: the prefetched window's pods overtake the gang, so
    the gang no longer leads the next pop and serial/pipelined pop
    orders diverge (caught by `deferred-gang-leads-next-pop`)."""
    m = protocols.gang_queue_model(front=True)
    return _swap(
        m, "resolve_window",
        effect=lambda s: protocols._resolve_effect(
            s, front=True, defer_to_back=True
        ),
    )


# ---- pipeline mutants ----------------------------------------------------


def mutant_fail_keeps_resident_commit() -> ProtocolModel:
    """The failure path forgets to roll back the optimistic resident
    commit: the next cycle deltas against a base the engine may not
    hold (caught by `failure-invalidates-resident`)."""
    m = protocols.pipeline_slot_model()
    return _swap(
        m, "complete_fail",
        effect=lambda s: {
            "inflight": 0, "spec": "none", "last_fail": True,
            "fail_budget": s["fail_budget"] - 1,
        },
        writes=frozenset({"inflight", "spec", "last_fail", "fail_budget"}),
    )


def mutant_dispatch_scores_stale_batch() -> ProtocolModel:
    """Dispatch adopts the speculative pod batch without re-checking
    the layout fingerprint — a stale batch (selector/node churn since
    the prebuild) gets scored (caught by
    `stale-spec-batch-never-scored`)."""
    m = protocols.pipeline_slot_model()
    old = next(t for t in m.transitions if t.name == "dispatch")
    return replace_transition(
        m, "dispatch",
        dataclasses.replace(
            old,
            effect=lambda s: {
                "inflight": 1, "spec": "none", "resident_ok": True,
                "last_fail": False,
                "scored_stale": s["scored_stale"] or s["spec"] == "stale",
            },
            reads=old.reads | frozenset({"scored_stale"}),
            writes=old.writes | frozenset({"scored_stale"}),
        ),
    )


# ---- replica mutant ------------------------------------------------------


def mutant_unfenced_replica_bind() -> ProtocolModel:
    """Replica B binds without the epoch CAS (no first-bind-wins
    fence): a blind overwrite of an already-bound pod (caught by
    `no-double-bind`)."""
    m = protocols.replica_bind_model()
    old = next(t for t in m.transitions if t.name == "bind_win_b")
    return replace_transition(
        m, "bind_win_b",
        dataclasses.replace(
            old,
            guard=lambda s: s["rb"] == "holds",
            effect=lambda s: {
                "pod_bound": "b",
                "pod_epoch": s["pod_epoch"] + 1,
                "rb": "idle",
                "double_bound": s["double_bound"]
                or s["pod_bound"] not in ("", "b"),
            },
            reads=old.reads | frozenset({"double_bound"}),
            writes=old.writes | frozenset({"double_bound"}),
        ),
    )


def mutant_shared_delta_unfenced() -> ProtocolModel:
    """The shared pool ships replica B's coalesced dispatch as a
    row-diff delta WITHOUT checking the resident epoch fence: after a
    flush/crash dropped the sidecar's base, a blind delta applies
    against state the engine no longer holds (caught by
    `shared-delta-fenced` via the ghost variable)."""
    m = protocols.replica_bind_model()
    return _swap(
        m, "dispatch_b",
        effect=lambda s: protocols._dispatch_effect(s, "b", fenced=False),
    )


# ---- degradation-ladder mutants ------------------------------------------


def mutant_ladder_skips_rung() -> ProtocolModel:
    """A failure path that drops a subsystem TWO rungs in one event —
    the silent multi-rung skip the one-rung demote contract forbids
    (caught by `never-skips-a-rung` via the ghost variable)."""
    from kubernetes_scheduler_tpu_torch.analysis.model.protocols import (
        _LADDER_BOTTOM,
        _BRK_THRESHOLD,
    )

    m = protocols.degradation_ladder_model()

    def skip_effect(s):
        new_rung = min(s["rung"] + 2, _LADDER_BOTTOM)
        fails = min(s["fails"] + 1, _BRK_THRESHOLD)
        opens = s["breaker"] == "half" or fails >= _BRK_THRESHOLD
        return {
            "fails": fails,
            "breaker": "open" if opens else s["breaker"],
            "rung": new_rung,
            "probed": False,
            "skipped": s["skipped"] or (new_rung - s["rung"] > 1),
        }

    return _swap(m, "attempt_fail", effect=skip_effect)


def mutant_promote_without_probe() -> ProtocolModel:
    """Recovery that climbs a rung without re-probing the degraded
    path (the guard dropped) — optimistic promotion re-enters the
    failure it degraded away from (caught by `recovery-re-probes`)."""
    m = protocols.degradation_ladder_model()
    old = next(t for t in m.transitions if t.name == "recover")
    return replace_transition(
        m, "recover",
        dataclasses.replace(
            old,
            guard=lambda s: (
                s["rung"] > 0 and not s["fault"] and s["breaker"] != "open"
            ),
        ),
    )


# ---- harness -------------------------------------------------------------

# name -> factory; ordered, so reports and tests stay deterministic
MUTANTS = {
    "invalidate-keeps-latches": mutant_invalidate_keeps_latches,
    "invalidate-keeps-wire-cache": mutant_invalidate_keeps_wire_cache,
    "partial-probe": mutant_partial_probe,
    "delta-across-layout-churn": mutant_delta_across_layout_churn,
    "defer-restores-to-back": mutant_defer_restores_to_back,
    "fail-keeps-resident-commit": mutant_fail_keeps_resident_commit,
    "dispatch-scores-stale-batch": mutant_dispatch_scores_stale_batch,
    "unfenced-replica-bind": mutant_unfenced_replica_bind,
    "shared-delta-unfenced": mutant_shared_delta_unfenced,
    "ladder-skips-rung": mutant_ladder_skips_rung,
    "promote-without-probe": mutant_promote_without_probe,
}


def run_mutant(name: str, **kw):
    """CheckResult for one seeded mutant (kw forwarded to check_model)."""
    return check_model(MUTANTS[name](), **kw)


def run_all(**kw) -> dict:
    """name -> CheckResult for the whole harness."""
    return {name: run_mutant(name, **kw) for name in MUTANTS}
