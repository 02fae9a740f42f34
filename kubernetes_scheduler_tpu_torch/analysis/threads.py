"""The declared thread model + happens-before substrate (thread-race and
determinism-taint), for the PyTorch/CUDA package.

Every concurrency guarantee the repo ships rests on assumptions the
lockset family alone cannot see: WHICH code runs on which thread, and
which cross-thread orderings (Event publication, queue hand-off,
thread start/join) make a lock-free access safe. This module makes
both explicit:

- `THREAD_ROOTS` is the registry of real thread entry points — the
  host serving loop, the pipelined in-flight completion stage, the
  BackgroundAdvisor refresh thread, the informer watch threads, the
  pending-pod feeder, the CycleTrigger waiter, the metrics HTTP
  handlers, the bridge RPC workers, the leader elector — each bound to
  code PR-10 style (`Anchor`-shaped fragments + call edges verified
  against the live ModuleIndex, so a refactor that moves a loop out
  from under its declared root fails lint instead of silently
  un-modeling a thread).

- `build_model(index)` resolves the registry against the index, ADDS
  every discovered spawn site (`threading.Thread(target=...)`,
  `threading.Thread` subclasses — so fixtures and scratch mutants are
  analyzable with no registry entry), and computes, per function, the
  set of thread identities that can reach it over a dispatch-extended
  call graph (attribute-typed `self.x.m()` calls resolved through
  constructor assignments; spawn edges deliberately excluded — a
  `Thread(target=f)` transfers control to a NEW thread, not this one).

- `class_concurrency(index, sf, cls)` collects every self-attribute
  access (reads AND writes, with the lexical lockset held at the
  site), plus the per-method happens-before facts the race family
  discharges pairs with: `Event.set`/`Event.wait` lines, `.start()` /
  `.join()` lines, and the set of thread-safe attributes (locks,
  Events, Queues, the repo's internally-locked Counter/Histogram/
  Gauge) whose method calls are hand-off edges rather than shared
  mutable state.

The model is an over-approximation with under-approximated reach
(RacerD-style): a function is only attributed to a thread the analysis
can PROVE reaches it, so missing dispatch edges cost findings, never
false ones.
"""

from __future__ import annotations

import ast
import builtins
from dataclasses import dataclass, field

from kubernetes_scheduler_tpu_torch.analysis.core import Violation, dotted_name
from kubernetes_scheduler_tpu_torch.analysis.dataflow import (
    class_lock_facts,
    method_entry_locksets,
    shallow_walk,
    _MUTATORS,
)

RULE = "thread-race"

# the serving thread's identity: declared host-loop roots and every
# discovered spawn-SITE (the code around a `t.start()` runs on the
# spawner's thread, which for this repo is always the serving loop or
# the harness driving it) share it, so setup-vs-cycle "pairs" on the
# same real thread can never fire
MAIN = "main"


# ---- the declared registry -------------------------------------------------


@dataclass(frozen=True)
class ThreadRoot:
    """One declared thread entry point, bound to code.

    name:         registry key (README's thread-root inventory table)
    thread:       identity; accesses from roots SHARING an identity run
                  on the same real thread and never race each other
    path:         repo-relative file
    func:         dotted def within the file ("Cls.method" / "fn")
    concurrent:   True when many instances of this thread run at once
                  (HTTP handler pool, gRPC workers) — a single write
                  site then conflicts with itself
    must_contain: source fragments that must appear in the resolved def
    calls:        bare callee names the def must reach (call graph)
    reaches:      extra entry qname tails ("Cls.method") the root is
                  DECLARED to reach — the modeling seam for dispatch
                  the static resolver cannot see (callbacks, bound
                  methods passed as values)
    description:  one line for the README inventory
    """

    name: str
    thread: str
    path: str
    func: str
    concurrent: bool = False
    must_contain: tuple = ()
    calls: tuple = ()
    reaches: tuple = ()
    description: str = ""


_PKG = "kubernetes_scheduler_tpu_torch"

THREAD_ROOTS: tuple[ThreadRoot, ...] = (
    ThreadRoot(
        name="host-loop",
        thread=MAIN,
        path=f"{_PKG}/kube/source.py",
        func="run_kube_loop",
        must_contain=("feeder.start()", "sched.run_cycle()"),
        description="the serving loop: feeder-fed cycles on the main thread",
    ),
    ThreadRoot(
        name="host-cycle",
        thread=MAIN,
        path=f"{_PKG}/host/scheduler.py",
        func="Scheduler.run_cycle",
        must_contain=("_run_cycle_pipelined", "_run_cycle_serial"),
        description="one scheduling cycle (serial or pipelined driver)",
    ),
    ThreadRoot(
        name="pipelined-completion",
        thread=MAIN,
        path=f"{_PKG}/host/scheduler.py",
        func="Scheduler._complete_cycle_split",
        must_contain=("self._observe_dispatch",),
        calls=("_observe_dispatch",),
        description=(
            "in-flight completion stage — the force half of the "
            "run_cycle_split seam, resolved ON the thread that calls "
            "complete() (the host loop, or a fleet drain completing "
            "replicas in order), not a thread of its own"
        ),
    ),
    ThreadRoot(
        name="cycle-trigger-waiter",
        thread=MAIN,
        path=f"{_PKG}/host/mirror.py",
        func="CycleTrigger.wait",
        must_contain=("self._evt.wait(timeout)", "self._evt.clear()"),
        description=(
            "event-driven idle wait; producers notify() from their own "
            "threads (set-then-clear-after-wait, no lost wakeups)"
        ),
    ),
    ThreadRoot(
        name="advisor-refresh",
        thread="advisor-refresh",
        path=f"{_PKG}/host/advisor.py",
        func="BackgroundAdvisor._run",
        must_contain=("self._refresh_once()", "self._stop.wait"),
        calls=("_refresh_once",),
        description="background utilization scrape loop",
    ),
    ThreadRoot(
        name="informer-watch",
        thread="informer-watch",
        path=f"{_PKG}/kube/source.py",
        func="InformerCache._resource_loop",
        concurrent=True,
        must_contain=("self._stop.is_set()", "self.client.watch"),
        reaches=(
            "SnapshotMirror.seed",
            "SnapshotMirror.apply_node_event",
            "SnapshotMirror.apply_pod_event",
        ),
        description=(
            "per-resource list+watch loops (nodes, pods, PDBs, "
            "namespaces, controllers, storage) — one thread each, all "
            "funneling through the cache lock; attach_mirror's on_event "
            "feeds the snapshot mirror from these threads"
        ),
    ),
    ThreadRoot(
        name="pending-feeder",
        thread="pending-feeder",
        path=f"{_PKG}/kube/source.py",
        func="_Feeder.run",
        must_contain=("watch_pending_events", "self._submit_new"),
        reaches=("Scheduler.submit", "CycleTrigger.notify"),
        description=(
            "pending-pod watcher feeding Scheduler.submit / the "
            "scheduling queue on arrival"
        ),
    ),
    ThreadRoot(
        name="metrics-http",
        thread="metrics-http",
        path=f"{_PKG}/host/observe.py",
        func="MetricsExporter._render_scheduler",
        concurrent=True,
        must_contain=("metrics_snapshot", "prom_collectors"),
        reaches=("Scheduler.metrics_snapshot", "Scheduler.arm_profile"),
        description=(
            "/metrics /healthz /debug/profile handlers (ThreadingHTTP"
            "Server: one thread per request)"
        ),
    ),
    ThreadRoot(
        name="bridge-worker",
        thread="bridge-worker",
        path=f"{_PKG}/bridge/server.py",
        func="EngineService.schedule_batch",
        concurrent=True,
        must_contain=("self._run(",),
        calls=("_resident_snapshot", "_run", "_finish_call"),
        description=(
            "sidecar RPC pool (schedule_batch/schedule_windows/preempt/"
            "health on a ThreadPoolExecutor); the device section is "
            "serialized by _device_lock, taken in _run"
        ),
    ),
    ThreadRoot(
        name="bridge-worker-windows",
        thread="bridge-worker",
        path=f"{_PKG}/bridge/server.py",
        func="EngineService.schedule_windows",
        concurrent=True,
        must_contain=("self._run(",),
        calls=("_run",),
        description="windows RPC on the same worker pool",
    ),
    ThreadRoot(
        name="bridge-worker-health",
        thread="bridge-worker",
        path=f"{_PKG}/bridge/server.py",
        func="EngineService.health",
        concurrent=True,
        description="health probe RPC on the same worker pool",
    ),
    ThreadRoot(
        name="leader-elector",
        thread="leader-elector",
        path=f"{_PKG}/host/leader.py",
        func="LeaderElector._run_loop",
        must_contain=("self._try_acquire_safe()", "time.monotonic()"),
        description="lease renew/re-acquire loop gating the serving loop",
    ),
)


def _def_source(fi) -> str:
    """ast.unparse of the def with docstrings stripped (anchors.py
    semantics — fragments match executable code, never prose)."""
    import copy

    node = copy.deepcopy(fi.node)
    for n in ast.walk(node):
        body = getattr(n, "body", None)
        if (
            isinstance(body, list) and body
            and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)
        ):
            n.body = body[1:] or [ast.Pass()]
    return ast.unparse(node)


def _resolve_root(index, root: ThreadRoot):
    qname = f"{root.path}::{root.func}"
    fi = index.funcs.get(qname)
    if fi is not None:
        return fi
    tail = "." + root.func
    cands = [
        f for q, f in index.funcs.items()
        if q.startswith(root.path + "::") and q.endswith(tail)
    ]
    return cands[0] if len(cands) == 1 else None


def verify_thread_roots(index, roots=THREAD_ROOTS) -> list[Violation]:
    """Anchor-drift check: every declared root whose file is in the
    index must still resolve, contain its fragments, and keep its call
    edges. Roots whose file is not in the lint scope are skipped — a
    fixture-only run cannot (and need not) verify the live registry."""
    out: list[Violation] = []
    paths = {f.sf.path for f in index.funcs.values()}
    for root in roots:
        if root.path not in paths:
            continue
        fi = _resolve_root(index, root)
        if fi is None:
            out.append(Violation(
                RULE, root.path, 1,
                f"declared thread root `{root.name}` is anchored to "
                f"`{root.func}`, which no longer exists in this file — "
                "the thread model (analysis/threads.THREAD_ROOTS) no "
                "longer matches the code; re-anchor the root or restore "
                "the entry point",
            ))
            continue
        src = _def_source(fi)
        line = fi.node.lineno
        for frag in root.must_contain:
            if frag not in src:
                out.append(Violation(
                    RULE, root.path, line,
                    f"thread root `{root.name}`: `{root.func}` no longer "
                    f"contains `{frag}` — the code moved out from under "
                    "the declared thread model; re-derive the root "
                    "(analysis/threads.THREAD_ROOTS) against the new "
                    "code",
                ))
        if root.calls:
            callee_names = {
                q.rsplit("::", 1)[-1].rsplit(".", 1)[-1]
                for q in index.callees(fi.qname)
            }
            for want in root.calls:
                if want not in callee_names and f"{want}(" not in src:
                    out.append(Violation(
                        RULE, root.path, line,
                        f"thread root `{root.name}`: `{root.func}` no "
                        f"longer calls `{want}` — the root's reach is "
                        "modeled on that edge; update THREAD_ROOTS or "
                        "the code",
                    ))
        for tail in root.reaches:
            if _tail_exists(index, tail) is False:
                out.append(Violation(
                    RULE, root.path, line,
                    f"thread root `{root.name}` declares a dispatch "
                    f"edge to `{tail}`, which no longer resolves "
                    "anywhere in the tree — the declared reach is the "
                    "seam static resolution cannot see, so a stale one "
                    "silently drops those accesses from the model; "
                    "update THREAD_ROOTS",
                ))
    return out


def _tail_exists(index, tail: str) -> bool | None:
    """True when the declared tail resolves, False when its owner is in
    the index but the def is gone (drift), None when the owner is not
    loaded at all — a scoped run cannot verify cross-file reaches (the
    full run does)."""
    suffix = "::" + tail if "." not in tail else "." + tail
    if any(
        q.endswith(suffix) or q.rsplit("::", 1)[-1] == tail
        for q in index.funcs
    ):
        return True
    if "." in tail:
        cls_name = tail.rsplit(".", 1)[0]
        owner_loaded = any(
            fi.cls is not None and fi.cls.name == cls_name
            for fi in index.funcs.values()
        )
        return False if owner_loaded else None
    return None


# ---- spawn-site discovery --------------------------------------------------

_THREAD_CTORS = {"Thread", "threading.Thread"}
_THREAD_BASES = {"Thread", "threading.Thread"}


def _is_thread_ctor(call: ast.Call) -> bool:
    dn = dotted_name(call.func)
    return dn in _THREAD_CTORS


def _spawn_targets(fi, call: ast.Call) -> list[str]:
    """Qnames a `threading.Thread(target=X)` ctor hands control to.

    Resolves `self._m` (enclosing class), bare same-file names, and the
    informer idiom — `target` loaded from a local list of bound methods
    (`loops = [self._node_loop, ...]; for target in loops: Thread(...)`).
    """
    target = None
    for kw in call.keywords:
        if kw.arg == "target":
            target = kw.value
    if target is None and call.args:
        target = call.args[0]
    if target is None:
        return []
    out: list[str] = []

    def _method_qname(attr: str) -> str | None:
        if fi.cls is None:
            return None
        q = fi.qname.rsplit(".", 1)[0] + "." + attr
        return q

    dn = dotted_name(target)
    if dn is not None:
        parts = dn.split(".")
        if parts[0] == "self" and len(parts) == 2:
            q = _method_qname(parts[1])
            if q is not None:
                out.append(q)
        elif len(parts) == 1:
            # bare name: a same-file def, or a local bound to a list of
            # bound methods (the informer start() loop)
            q = f"{fi.sf.path}::{parts[0]}"
            if q not in out:
                out.append(q)
            for node in shallow_walk(fi.node):
                if not isinstance(node, (ast.Assign, ast.AugAssign)):
                    continue
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                if not any(
                    isinstance(t, ast.Name) and t.id == parts[0]
                    for t in targets
                ):
                    continue
                for elt in ast.walk(node.value):
                    edn = dotted_name(elt)
                    if edn and edn.startswith("self.") and edn.count(".") == 1:
                        q = _method_qname(edn.split(".", 1)[1])
                        if q is not None and q not in out:
                            out.append(q)
    return out


# ---- the dispatch-extended reachability graph ------------------------------

# attributes holding these constructions are synchronization objects or
# internally-locked hand-off structures: method calls on them are HB
# edges (Queue.put/get, Event.set/wait) or thread-safe feeds
# (Counter.inc under its own lock), not shared mutable state. Rebinding
# the attribute itself outside __init__ still counts as a write.
SAFE_CTORS = {
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
    "Barrier", "Event", "Queue", "SimpleQueue", "LifoQueue",
    "PriorityQueue", "deque", "Counter", "Histogram", "Gauge",
    "CycleTrigger", "local",
    # repo classes that serialize internally (their own threading.Lock
    # around every mutation) — calls on them are thread-safe feeds
    "SpanWriter",
}


def _ctor_name(value: ast.AST) -> str | None:
    if isinstance(value, ast.Call):
        dn = dotted_name(value.func)
        if dn:
            return dn.rsplit(".", 1)[-1]
    return None


def _class_key(sf, cls: ast.ClassDef) -> str:
    return f"{sf.path}::{cls.name}"


class ThreadModel:
    """threads_of: qname -> set of thread identities proven to reach it;
    concurrent: identities with >1 simultaneous instance; roots: the
    resolved (declared + discovered) entry list for rendering."""

    def __init__(self):
        self.threads_of: dict[str, set[str]] = {}
        self.concurrent: set[str] = set()
        self.roots: list[tuple[str, str, str]] = []  # (identity, name, qname)

    def threads(self, qname: str) -> frozenset:
        return frozenset(self.threads_of.get(qname, ()))


def _attr_types(index) -> dict[tuple[str, str], set[str]]:
    """(class key, attr) -> class keys the attr may hold, read off
    `self.a = ClassName(...)` ctor assignments (imports/same-file
    resolved loosely by class name) and one level of return-ctor
    inference through project factory functions."""
    out: dict[tuple[str, str], set[str]] = {}

    def _classes_for(name: str) -> list[str]:
        return [
            _class_key(sf, cls) for sf, cls in index.classes.get(name, ())
        ]

    def _returned_classes(fname: str) -> list[str]:
        keys: list[str] = []
        for cand in index.by_name.get(fname, ()):
            for node in shallow_walk(cand.node):
                if isinstance(node, ast.Return) and node.value is not None:
                    cn = _ctor_name(node.value)
                    if cn:
                        keys.extend(_classes_for(cn))
        return keys

    for fi in index.funcs.values():
        if fi.cls is None:
            continue
        owner = _class_key(fi.sf, fi.cls)
        for node in shallow_walk(fi.node):
            if not isinstance(node, ast.Assign):
                continue
            cn = _ctor_name(node.value)
            if not cn:
                continue
            keys = _classes_for(cn) or _returned_classes(cn)
            if not keys:
                continue
            for t in node.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    out.setdefault((owner, t.attr), set()).update(keys)
    return out


_LOOSE_CAP = 3  # an unresolved bare call lands on ≤ this many same-named
# defs project-wide, or the edge is dropped — thread attribution must
# never ride a name like `close` that forty classes define

_BUILTINS = frozenset(dir(builtins))  # set()/id() are never project calls


def thread_edges(index) -> dict[str, set[str]]:
    """The reachability graph thread identities propagate over: tight
    resolution (self.m / imports / same-file) + attribute-typed
    dispatch (`self.x.m()` through ctor assignments, local `x = Cls()`
    included) + a capped loose fallback — with `Thread(target=...)`
    spawn edges EXCLUDED (control moves to a new thread there; the
    spawned side enters the model as its own root)."""
    attr_types = _attr_types(index)
    method_index: dict[tuple[str, str], str] = {}
    for q, fi in index.funcs.items():
        if fi.cls is not None:
            cls_key = q.rsplit(".", 1)[0]
            method_index[(cls_key, fi.name)] = q

    edges: dict[str, set[str]] = {q: set() for q in index.funcs}
    for q, fi in index.funcs.items():
        owner = _class_key(fi.sf, fi.cls) if fi.cls is not None else None
        local_types: dict[str, set[str]] = {}
        for node in shallow_walk(fi.node):
            if isinstance(node, ast.Assign):
                cn = _ctor_name(node.value)
                if cn and cn in index.classes:
                    keys = {
                        _class_key(sf, cls)
                        for sf, cls in index.classes[cn]
                    }
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            local_types.setdefault(t.id, set()).update(keys)
            if not isinstance(node, ast.Call):
                continue
            if _is_thread_ctor(node):
                continue  # spawn, not a call edge on this thread
            cands = index.resolve_call(fi, node, loose=False)
            if cands:
                edges[q].update(c.qname for c in cands)
                continue
            dn = dotted_name(node.func)
            if dn is None:
                continue
            parts = dn.split(".")
            hit = False
            if len(parts) == 3 and parts[0] == "self" and owner is not None:
                for cls_key in attr_types.get((owner, parts[1]), ()):
                    callee = method_index.get((cls_key, parts[2]))
                    if callee is not None:
                        edges[q].add(callee)
                        hit = True
            elif len(parts) == 2 and parts[0] in local_types:
                for cls_key in local_types[parts[0]]:
                    callee = method_index.get((cls_key, parts[1]))
                    if callee is not None:
                        edges[q].add(callee)
                        hit = True
            if not hit and len(parts) == 1 and parts[0] not in _BUILTINS:
                # bare project calls only: a dotted `obj.append(...)` on
                # an untyped receiver must NOT land on some class's
                # `append` — thread attribution never rides a method
                # name forty receivers share
                loose = index.by_name.get(parts[0], ())
                if 0 < len(loose) <= _LOOSE_CAP:
                    edges[q].update(c.qname for c in loose)
    return edges


def _reach(edges: dict[str, set[str]], entries) -> set[str]:
    seen: set[str] = set()
    stack = [q for q in entries if q in edges]
    while stack:
        q = stack.pop()
        if q in seen:
            continue
        seen.add(q)
        stack.extend(c for c in edges.get(q, ()) if c not in seen)
    return seen


def build_model(index, roots=THREAD_ROOTS) -> ThreadModel:
    """Resolve the declared registry + discover spawn sites, then
    propagate thread identities over the dispatch-extended graph."""
    model = ThreadModel()
    edges = thread_edges(index)
    entries: dict[str, set[str]] = {}  # identity -> entry qnames

    def _tail_qnames(tail: str) -> list[str]:
        suffix = "::" + tail if "." not in tail else "." + tail
        return [
            q for q in index.funcs
            if q.endswith(suffix) or q.endswith("::" + tail)
        ]

    paths = {f.sf.path for f in index.funcs.values()}
    for root in roots:
        if root.path not in paths:
            continue
        fi = _resolve_root(index, root)
        if fi is None:
            continue  # drift is verify_thread_roots's finding, not a crash
        entries.setdefault(root.thread, set()).add(fi.qname)
        if root.concurrent:
            model.concurrent.add(root.thread)
        model.roots.append((root.thread, root.name, fi.qname))
        for tail in root.reaches:
            for q in _tail_qnames(tail):
                entries[root.thread].add(q)

    # discovered spawns: each target is its own identity UNLESS it is
    # already a declared root's entry (declaring `_Feeder.run` as
    # pending-feeder must not ALSO mint a worker identity for the same
    # real thread — a function would then conflict with itself); the
    # spawning function (and everything that reaches it) runs on MAIN
    declared_qnames = {q for ents in entries.values() for q in ents}
    spawners: set[str] = set()
    for q, fi in index.funcs.items():
        for node in shallow_walk(fi.node):
            if isinstance(node, ast.Call) and _is_thread_ctor(node):
                spawners.add(q)
                for tq in _spawn_targets(fi, node):
                    if tq in index.funcs and tq not in declared_qnames:
                        ident = "worker:" + tq.rsplit("::", 1)[-1]
                        entries.setdefault(ident, set()).add(tq)
                        model.roots.append((ident, ident, tq))
    for name, cands in index.classes.items():
        for sf, cls in cands:
            bases = {dotted_name(b) for b in cls.bases}
            if bases & _THREAD_BASES:
                q = f"{sf.path}::{cls.name}.run"
                if q in index.funcs and q not in declared_qnames:
                    ident = f"worker:{cls.name}.run"
                    entries.setdefault(ident, set()).add(q)
                    model.roots.append((ident, ident, q))

    if spawners:
        # reverse closure: whoever transitively calls a spawner runs on
        # the spawner's (main) thread up to that point
        rev: dict[str, set[str]] = {}
        for src, dsts in edges.items():
            for d in dsts:
                rev.setdefault(d, set()).add(src)
        main_entries = _reach(rev, spawners)
        entries.setdefault(MAIN, set()).update(main_entries)

    for ident, ents in entries.items():
        for q in _reach(edges, ents):
            model.threads_of.setdefault(q, set()).add(ident)
    return model


# ---- per-class access + happens-before facts -------------------------------


@dataclass
class Access:
    attr: str
    kind: str            # "w" | "r"
    qname: str           # method qname
    method: str
    line: int
    held: frozenset      # lock attrs lexically held at the site


@dataclass
class MethodHB:
    """Per-method happens-before facts the discharge logic consumes."""

    sets: list = field(default_factory=list)    # (event attr, line)
    waits: list = field(default_factory=list)   # (event attr, line)
    starts: list = field(default_factory=list)  # lineno of any .start()
    joins: list = field(default_factory=list)   # lineno of any .join()


@dataclass
class ClassConcurrency:
    cls_name: str
    path: str
    accesses: dict = field(default_factory=dict)   # attr -> [Access]
    hb: dict = field(default_factory=dict)         # method -> MethodHB
    entry_locksets: dict = field(default_factory=dict)
    safe_attrs: set = field(default_factory=set)
    event_attrs: set = field(default_factory=set)
    methods: dict = field(default_factory=dict)    # method name -> qname


def _self_attr_read(node) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
        and isinstance(node.ctx, ast.Load)
        # keyed `self.__dict__[...]` forms are resolved to the KEY (they
        # ARE `self.<key>`); the bare dict object itself is not a datum
        and node.attr != "__dict__"
    ):
        return node.attr
    return None


def self_dict_sub(node) -> str | None:
    """'key' for a `self.__dict__["key"]` Subscript — semantically an
    access to `self.key`, and tracked at that granularity (the memoized-
    property idiom must not conflate every cache under one `__dict__`
    attr: two threads touching DIFFERENT keys never conflict)."""
    if (
        isinstance(node, ast.Subscript)
        and isinstance(node.value, ast.Attribute)
        and isinstance(node.value.value, ast.Name)
        and node.value.value.id == "self"
        and node.value.attr == "__dict__"
        and isinstance(node.slice, ast.Constant)
        and isinstance(node.slice.value, str)
    ):
        return node.slice.value
    return None


def self_dict_get(node) -> str | None:
    """'key' for a `self.__dict__.get("key", ...)` call (read)."""
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "get"
        and isinstance(node.func.value, ast.Attribute)
        and isinstance(node.func.value.value, ast.Name)
        and node.func.value.value.id == "self"
        and node.func.value.attr == "__dict__"
        and node.args
        and isinstance(node.args[0], ast.Constant)
        and isinstance(node.args[0].value, str)
    ):
        return node.args[0].value
    return None


def class_concurrency(index, sf, cls: ast.ClassDef) -> ClassConcurrency:
    facts = class_lock_facts(cls)
    cc = ClassConcurrency(cls_name=cls.name, path=sf.path)
    cc.entry_locksets = method_entry_locksets(facts) if facts.locks else {}
    for item in ast.walk(cls):
        if isinstance(item, ast.Assign):
            cn = _ctor_name(item.value)
            if cn in SAFE_CTORS:
                for t in item.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        cc.safe_attrs.add(t.attr)
                        if cn == "Event":
                            cc.event_attrs.add(t.attr)
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        method = item.name
        qname = None
        for q, fi in index.funcs.items():
            if fi.node is item:
                qname = q
                break
        if qname is None:
            qname = f"{sf.path}::{cls.name}.{method}"
        cc.methods[method] = qname
        hb = MethodHB()
        cc.hb[method] = hb

        def walk(node, held):
            for child in ast.iter_child_nodes(node):
                child_held = held
                if isinstance(child, ast.With):
                    acquired = {
                        i.context_expr.attr
                        for i in child.items
                        if (
                            isinstance(i.context_expr, ast.Attribute)
                            and isinstance(i.context_expr.value, ast.Name)
                            and i.context_expr.value.id == "self"
                            and i.context_expr.attr in facts.locks
                        )
                    }
                    if acquired:
                        child_held = held | acquired
                if isinstance(child, ast.Call):
                    dget = self_dict_get(child)
                    if dget is not None:
                        cc.accesses.setdefault(dget, []).append(Access(
                            dget, "r", qname, method, child.lineno,
                            frozenset(child_held),
                        ))
                    fdn = dotted_name(child.func)
                    if fdn and "." in fdn:
                        owner, mname = fdn.rsplit(".", 1)
                        if mname == "start":
                            hb.starts.append(child.lineno)
                        elif mname == "join":
                            hb.joins.append(child.lineno)
                        if owner.startswith("self.") and owner.count(".") == 1:
                            attr = owner.split(".", 1)[1]
                            if (
                                attr in cc.event_attrs
                                or "evt" in attr or "event" in attr
                            ):
                                if mname == "set":
                                    hb.sets.append((attr, child.lineno))
                                elif mname == "wait":
                                    hb.waits.append((attr, child.lineno))
                    # mutator calls on plain (non-hand-off) attrs write
                    if (
                        isinstance(child.func, ast.Attribute)
                        and child.func.attr in _MUTATORS
                    ):
                        owner_node = child.func.value
                        if isinstance(owner_node, ast.Subscript):
                            owner_node = owner_node.value
                        if (
                            isinstance(owner_node, ast.Attribute)
                            and isinstance(owner_node.value, ast.Name)
                            and owner_node.value.id == "self"
                            and owner_node.attr not in cc.safe_attrs
                        ):
                            cc.accesses.setdefault(
                                owner_node.attr, []
                            ).append(Access(
                                owner_node.attr, "w", qname, method,
                                child.lineno, frozenset(child_held),
                            ))
                elif isinstance(child, (ast.Assign, ast.AugAssign)):
                    targets = (
                        child.targets if isinstance(child, ast.Assign)
                        else [child.target]
                    )
                    for t in targets:
                        dkey = self_dict_sub(t)
                        if dkey is not None:
                            cc.accesses.setdefault(dkey, []).append(
                                Access(
                                    dkey, "w", qname, method,
                                    child.lineno, frozenset(child_held),
                                )
                            )
                            continue
                        base = t
                        if isinstance(base, ast.Subscript):
                            base = base.value
                        if (
                            isinstance(base, ast.Attribute)
                            and isinstance(base.value, ast.Name)
                            and base.value.id == "self"
                            and base.attr != "__dict__"
                        ):
                            # rebinding even a hand-off attr is a write
                            cc.accesses.setdefault(base.attr, []).append(
                                Access(
                                    base.attr, "w", qname, method,
                                    child.lineno, frozenset(child_held),
                                )
                            )
                dkey = self_dict_sub(child)
                if dkey is not None and isinstance(child.ctx, ast.Load):
                    cc.accesses.setdefault(dkey, []).append(Access(
                        dkey, "r", qname, method, child.lineno,
                        frozenset(child_held),
                    ))
                attr = _self_attr_read(child)
                if attr is not None and attr not in cc.safe_attrs:
                    cc.accesses.setdefault(attr, []).append(Access(
                        attr, "r", qname, method, child.lineno,
                        frozenset(child_held),
                    ))
                if not isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
                ):
                    walk(child, child_held)

        walk(item, frozenset())
    return cc


def guaranteed_locks(cc: ClassConcurrency, acc: Access) -> frozenset:
    """Locks held on EVERY path reaching the site: the lexical set plus
    the intersection of the method's entry locksets (lockset-race's
    fixpoint, reused — a private helper only ever called under the lock
    inherits it without a waiver)."""
    contexts = cc.entry_locksets.get(acc.method)
    if not contexts:
        return acc.held
    inter = None
    for c in contexts:
        inter = set(c) if inter is None else inter & c
    return acc.held | frozenset(inter or ())
