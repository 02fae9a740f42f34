"""Interprocedural cross-thread race detection over the declared thread
model: every object-attribute (and module-global) access reachable from
two or more thread roots must be ordered — by a common lockset, or by a
happens-before edge the model proves (write published before
`Thread.start()`, write-then-`Event.set()` consumed after
`Event.wait()`, reader behind a `.join()`, hand-off through a
`Queue`/`deque`/internally-locked collector) — plus check-then-act
atomicity on shared attributes. Subsumes and strengthens
`lockset-race`: that family checks lock CONSISTENCY within a class;
this one checks cross-thread ORDERING, with the set-before-start and
queue-hand-off patterns proven instead of waived."""

from __future__ import annotations

import ast

from kubernetes_scheduler_tpu_torch.analysis.core import Violation, dotted_name
from kubernetes_scheduler_tpu_torch.analysis import dataflow, threads

RULE = threads.RULE  # "thread-race"

# the threaded layers; kernel/engine/sim code runs single-threaded under
# the drivers and is exempt by scope configuration, not by waiver
_SCOPE_DIRS = (
    "kubernetes_scheduler_tpu_torch/host/",
    "kubernetes_scheduler_tpu_torch/kube/",
    "kubernetes_scheduler_tpu_torch/bridge/",
    "kubernetes_scheduler_tpu_torch/trace/",
)


def _in_scope(path: str) -> bool:
    if not path.startswith("kubernetes_scheduler_tpu_torch/"):
        return True  # fixtures / scratch mutants: always analyzed
    return path.startswith(_SCOPE_DIRS)


def _conflicting(t1: frozenset, t2: frozenset, concurrent: set) -> str | None:
    """A pair of identity sets conflicts when two DIFFERENT identities
    can execute the sites, or one concurrent identity can execute both
    (two HTTP handler threads in the same method). Returns a rendered
    'a vs b' tag, or None."""
    for a in t1:
        for b in t2:
            if a != b:
                return f"{a} vs {b}"
            if a in concurrent:
                return f"{a} (concurrent instances)"
    return None


def _hb_discharged(cc, w: threads.Access, s: threads.Access) -> bool:
    """True when a proven happens-before edge orders the pair."""
    w_hb = cc.hb.get(w.method)
    s_hb = cc.hb.get(s.method)
    if w_hb is None or s_hb is None:
        return False
    # publication before Thread.start(): everything the spawning method
    # writes before the start() call is visible to the spawned thread
    if any(line >= w.line for line in w_hb.starts):
        return True
    if s.kind == "w" and any(line >= s.line for line in s_hb.starts):
        return True
    # Event publication: writer sets e AFTER the write, observer read
    # comes AFTER waiting on the same e
    for e, set_line in w_hb.sets:
        if set_line >= w.line and any(
            we == e and wait_line <= s.line for we, wait_line in s_hb.waits
        ):
            return True
    for e, set_line in s_hb.sets:
        if s.kind == "w" and set_line >= s.line and any(
            we == e and wait_line <= w.line for we, wait_line in w_hb.waits
        ):
            return True
    # join: an access behind a .join() happens-after the joined thread's
    # writes (either side may be the joiner)
    if any(line <= s.line for line in s_hb.joins):
        return True
    if any(line <= w.line for line in w_hb.joins):
        return True
    return False


def _class_races(index, model, sf, cls, out) -> None:
    cc = threads.class_concurrency(index, sf, cls)
    reported: set = set()
    for attr, accesses in sorted(cc.accesses.items()):
        writes = [
            a for a in accesses
            if a.kind == "w" and a.method != "__init__"
        ]
        if not writes:
            continue
        for w in writes:
            tw = model.threads(w.qname)
            if not tw:
                continue
            for s in accesses:
                if s.method == "__init__":
                    continue  # construction happens-before publication
                if s.kind == "w" and (s.qname, s.line) < (w.qname, w.line):
                    continue  # each unordered write/write pair once
                if s.kind == "r" and s.qname == w.qname and s.line == w.line:
                    continue  # the write's own receiver load
                ts = model.threads(s.qname)
                tag = _conflicting(tw, ts, model.concurrent)
                if tag is None:
                    continue
                gw = threads.guaranteed_locks(cc, w)
                gs = threads.guaranteed_locks(cc, s)
                if gw & gs:
                    continue  # common lockset orders the pair
                if _hb_discharged(cc, w, s):
                    continue
                key = (attr, w.method, s.method, s.kind)
                if key in reported:
                    continue
                reported.add(key)
                verb = "written" if s.kind == "w" else "read"
                # anchor the finding at the LOCK-FREE side — that's the
                # site needing the guard (or the waiver, for an intended
                # bulk-sync read)
                anchor = s.line if (gw and not gs) else w.line
                out.append(Violation(
                    RULE, sf.path, anchor,
                    f"`{cc.cls_name}.{attr}` is written in `{w.method}` "
                    f"(line {w.line}) and {verb} in `{s.method}` (line "
                    f"{s.line}) on different threads ({tag}) with no "
                    "common lockset and no happens-before edge — guard "
                    "both sites with one lock, publish the write before "
                    "the reader's thread starts, pair it with an "
                    "Event.set()/wait(), hand the value off through a "
                    "Queue, or join the writing thread first",
                ))


def _check_then_act(index, model, sf, cls, out) -> None:
    """`if <self.attr test>: ... self.attr = ...` with no lock covering
    both test and act, on an attribute other threads write: the classic
    lost-update latch (two threads both see the un-set state)."""
    cc = threads.class_concurrency(index, sf, cls)
    shared_written = set()
    for attr, accesses in cc.accesses.items():
        idents = set()
        for a in accesses:
            if a.kind == "w" and a.method != "__init__":
                idents |= model.threads(a.qname)
        if len(idents) > 1 or idents & model.concurrent:
            shared_written.add(attr)
    if not shared_written:
        return
    for method, qname in cc.methods.items():
        if method == "__init__":
            continue
        idents = model.threads(qname)
        if not (len(idents) > 1 or idents & model.concurrent):
            continue
        fi = index.funcs.get(qname)
        if fi is None:
            continue
        by_line = {}
        for attr, accesses in cc.accesses.items():
            for a in accesses:
                if a.qname == qname:
                    by_line.setdefault(a.line, []).append(a)

        def held_at(line, kind, attr):
            for a in by_line.get(line, ()):
                if a.attr == attr and a.kind == kind:
                    return threads.guaranteed_locks(cc, a)
            return None

        for node in dataflow.shallow_walk(fi.node):
            if not isinstance(node, ast.If):
                continue
            tested = set()
            for n in ast.walk(node.test):
                if (
                    isinstance(n, ast.Attribute)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "self"
                ):
                    tested.add(n.attr)
                for k in (threads.self_dict_sub(n), threads.self_dict_get(n)):
                    if k is not None:
                        tested.add(k)
            tested &= shared_written
            if not tested:
                continue
            for stmt in ast.walk(node):
                if not isinstance(stmt, (ast.Assign, ast.AugAssign)):
                    continue
                targets = (
                    stmt.targets if isinstance(stmt, ast.Assign)
                    else [stmt.target]
                )
                for t in targets:
                    written_attr = threads.self_dict_sub(t)
                    if written_attr is None:
                        base = t
                        if isinstance(base, ast.Subscript):
                            base = base.value
                        if (
                            isinstance(base, ast.Attribute)
                            and isinstance(base.value, ast.Name)
                            and base.value.id == "self"
                        ):
                            written_attr = base.attr
                    if written_attr not in tested:
                        continue
                    test_held = held_at(node.test.lineno, "r", written_attr)
                    act_held = held_at(stmt.lineno, "w", written_attr)
                    if (
                        test_held is not None and act_held is not None
                        and test_held & act_held
                    ):
                        continue  # one lock covers check AND act
                    out.append(Violation(
                        RULE, sf.path, node.lineno,
                        f"check-then-act on `{cc.cls_name}.{written_attr}` "
                        f"in `{method}`: the test (line "
                        f"{node.test.lineno}) and the write (line "
                        f"{stmt.lineno}) are not covered by one lock, "
                        "and other threads write this attribute — two "
                        "threads can both observe the un-set state; "
                        "take the lock around the whole "
                        "test-and-assign (double-checked re-test under "
                        "the lock is the sanctioned idiom)",
                    ))


def _module_global_races(index, model, sf, out) -> None:
    """Writes to `global X` names from functions on different threads,
    with reads of the same module-level name — module locks
    (`with _LOCK:` over a module-level Lock()) discharge."""
    tree = sf.tree
    module_locks = set()
    mutable_globals = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            cname = dotted_name(node.value.func)
            cname = cname.rsplit(".", 1)[-1] if cname else None
            for t in node.targets:
                if isinstance(t, ast.Name):
                    if cname in ("Lock", "RLock"):
                        module_locks.add(t.id)
                    elif cname in ("dict", "list", "set"):
                        mutable_globals.add(t.id)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and isinstance(
                    node.value, (ast.Dict, ast.List, ast.Set)
                ):
                    mutable_globals.add(t.id)
    writers: dict[str, list] = {}
    readers: dict[str, list] = {}
    for fi in index.functions(sf):
        declared = set()
        for node in dataflow.shallow_walk(fi.node):
            if isinstance(node, ast.Global):
                declared.update(node.names)

        def locked_walk(node, held):
            for child in ast.iter_child_nodes(node):
                child_held = held
                if isinstance(child, ast.With):
                    acq = {
                        dotted_name(i.context_expr)
                        for i in child.items
                    } & module_locks
                    if acq:
                        child_held = held | acq
                if isinstance(child, ast.Assign):
                    for t in child.targets:
                        if isinstance(t, ast.Name) and t.id in declared:
                            writers.setdefault(t.id, []).append(
                                (fi, child.lineno, frozenset(child_held))
                            )
                elif (
                    isinstance(child, ast.Name)
                    and isinstance(child.ctx, ast.Load)
                    and (child.id in declared or child.id in mutable_globals)
                ):
                    readers.setdefault(child.id, []).append(
                        (fi, child.lineno, frozenset(child_held))
                    )
                if not isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
                ):
                    locked_walk(child, child_held)

        locked_walk(fi.node, frozenset())
    for name, wsites in sorted(writers.items()):
        for wfi, wline, wheld in wsites:
            tw = model.threads(wfi.qname)
            for rfi, rline, rheld in readers.get(name, []) + [
                (f, ln, h) for f, ln, h in wsites if (f, ln) != (wfi, wline)
            ]:
                ts = model.threads(rfi.qname)
                tag = _conflicting(tw, ts, model.concurrent)
                if tag is None or (wheld & rheld):
                    continue
                out.append(Violation(
                    RULE, sf.path, wline,
                    f"module global `{name}` is written in "
                    f"`{wfi.name}` (line {wline}) and touched in "
                    f"`{rfi.name}` (line {rline}) on different threads "
                    f"({tag}) with no common module lock — guard both "
                    "sites with one module-level Lock",
                ))
                break  # one finding per write site


def check(ctx) -> list[Violation]:
    index = dataflow.get_index(ctx)
    out: list[Violation] = []
    # declared thread model: anchor drift is a finding, not a crash
    out.extend(threads.verify_thread_roots(index))
    model = threads.build_model(index)
    for sf in ctx.files:
        if not _in_scope(sf.path):
            continue
        for node in sf.tree.body:
            if isinstance(node, ast.ClassDef):
                _class_races(index, model, sf, node, out)
                _check_then_act(index, model, sf, node, out)
        _module_global_races(index, model, sf, out)
    return out
