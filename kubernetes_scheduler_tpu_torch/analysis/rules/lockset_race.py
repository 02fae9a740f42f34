"""lockset-race: every mutation of a lock-guarded attribute must hold a
CONSISTENT lockset — computed through the class's call graph, not per
method body.

The per-file `lock-discipline` family sees only lexical `with
self._lock:` blocks, so a private helper that mutates guarded state with
the lock held BY ITS CALLER needs a hand-written waiver asserting the
call-site discipline. This family promotes that assertion into the
analysis: per class, every `with self.<lock>:` context is threaded
through intra-class `self.m(...)` calls to a fixpoint of ENTRY locksets
(analysis/dataflow.py `method_entry_locksets`):

- public methods are entries with the empty lockset — the scheduling
  loop, the bridge's gRPC worker threads, and the /metrics scrape can
  all call them lock-free, which is exactly the cross-thread shape the
  pipelined driver's completion stage vs. the exporter's reader takes;
- a private helper inherits the locksets of its intra-class call sites,
  so `_flush` called only under `self._lock` mutates guarded state
  SAFELY — no waiver needed, the call graph proves it;
- a mutation site's effective locksets are its entry contexts unioned
  with the locks lexically held at the site.

A violation is an attribute with one mutation site always guarded by
some lock and another site reachable (through the call graph) holding
NO common lock — the torn-write window between the driver thread and a
bridge/exporter thread. The seeded targets this family exists for:
`engine.ResidentState`'s retained snapshot swap, the bridge server's
session maps (`_field_cache`), and the host scheduler's metrics state
shared with the exporter thread.

`__init__` stays exempt (construction happens-before publication).
"""

from __future__ import annotations

import ast

from kubernetes_scheduler_tpu_torch.analysis.core import Context, Violation
from kubernetes_scheduler_tpu_torch.analysis import dataflow

RULE = "lockset-race"

SCOPE = ("kubernetes_scheduler_tpu_torch/**/*.py", "kubernetes_scheduler_tpu_torch/*.py")


def check(ctx: Context) -> list[Violation]:
    out: list[Violation] = []
    index = dataflow.get_index(ctx)
    for sf in ctx.scoped(SCOPE):
        for node in index.walk(sf):
            if isinstance(node, ast.ClassDef):
                _check_class(sf, node, out)
    return out


def _check_class(sf, cls: ast.ClassDef, out: list[Violation]) -> None:
    facts = dataflow.class_lock_facts(cls)
    if not facts.locks:
        return
    contexts = dataflow.method_entry_locksets(facts)
    # attr -> [(method, line, set of effective locksets)]
    sites: dict[str, list] = {}
    for method, muts in facts.mutations.items():
        if method == "__init__":
            continue
        entry = contexts.get(method, {frozenset()})
        if not entry:
            # a private helper whose only intra-class callers are
            # __init__ (or a helper chain rooted there) has an EMPTY
            # context set: it is unreachable after publication, so its
            # mutations inherit __init__'s happens-before exemption
            continue
        for attr, line, held in muts:
            if attr in facts.locks:
                continue
            effective = {frozenset(c | held) for c in entry}
            sites.setdefault(attr, []).append((method, line, effective))
    for attr, slist in sorted(sites.items()):
        # locks held on EVERY path into each site
        guards = [
            (method, line, frozenset.intersection(*eff) if eff else frozenset())
            for method, line, eff in slist
        ]
        always_guarded = [g for g in guards if g[2]]
        if not always_guarded:
            continue  # never guarded anywhere: not a lockset claim
        # the lock(s) the guarded sites agree on
        common = frozenset.intersection(*[g[2] for g in always_guarded])
        all_guards = sorted(set().union(*[g[2] for g in always_guarded]))
        for method, line, locks in guards:
            if common and common & locks:
                continue
            if locks:
                # the site DOES hold a lock — just not one every other
                # guarded site agrees on (two locks "guarding" one attr
                # guard nothing): say that, not "no lock"
                msg = (
                    f"{cls.name}.{method} mutates `self.{attr}` under an "
                    f"inconsistent lockset (`{', '.join(sorted(locks))}` "
                    f"here vs `{', '.join(all_guards)}` elsewhere in this "
                    "class — no common lock serializes the writes)"
                )
            else:
                guard_names = ", ".join(sorted(common)) or ", ".join(
                    all_guards
                )
                msg = (
                    f"{cls.name}.{method} mutates `self.{attr}` on a path "
                    f"holding no common lock, but `{guard_names}` guards "
                    "it elsewhere in this class (reachable lock-free "
                    "through the class's call graph)"
                )
            out.append(Violation(RULE, sf.path, line, msg))
