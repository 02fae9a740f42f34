"""lock-discipline: attrs mutated under a class's lock stay under it.

For every class that takes a threading lock (`self._lock = Lock()` /
`RLock()`, or any `with self.<x>lock:` usage), the set of self-attributes
mutated inside a lock block in ANY method defines that class's guarded
state. Mutating a guarded attribute lock-free in another method (or
outside the lock in the same method) is the cross-thread torn-write
pattern the advisor/queue/bridge classes are built to avoid.

`__init__` is exempt (construction happens-before publication). A
helper method that mutates guarded state with the lock held BY ITS
CALLER does fire (the rule cannot see call-site locking) — waive it
inline, naming the callers that hold the lock; the helper's own writes
never count as guarded. Mutations through local aliases
(`d = self._x; d[k] = v`) are invisible — keep lock-guarded mutation on
the attribute itself where the rule can see it.
"""

from __future__ import annotations

import ast

from kubernetes_scheduler_tpu_torch.analysis import dataflow
from kubernetes_scheduler_tpu_torch.analysis.core import Context, Violation

RULE = "lock-discipline"

SCOPE = ("kubernetes_scheduler_tpu_torch/**/*.py", "kubernetes_scheduler_tpu_torch/*.py")

_MUTATORS = {
    "append", "extend", "insert", "pop", "popitem", "clear", "update",
    "add", "discard", "remove", "setdefault", "appendleft", "popleft",
}
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore"}


def _lock_attrs(cls: ast.ClassDef) -> set:
    """self.<attr> holding a threading lock, plus any self.<attr> used as
    a with-context whose name mentions 'lock'."""
    locks: set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(
            node.value, ast.Call
        ):
            fn = node.value.func
            ctor = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None
            )
            if ctor in _LOCK_CTORS:
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        locks.add(t.attr)
        elif isinstance(node, ast.With):
            for item in node.items:
                e = item.context_expr
                if (
                    isinstance(e, ast.Attribute)
                    and isinstance(e.value, ast.Name)
                    and e.value.id == "self"
                    and "lock" in e.attr.lower()
                ):
                    locks.add(e.attr)
    return locks


def _is_lock_with(node: ast.With, locks: set) -> bool:
    for item in node.items:
        e = item.context_expr
        if (
            isinstance(e, ast.Attribute)
            and isinstance(e.value, ast.Name)
            and e.value.id == "self"
            and e.attr in locks
        ):
            return True
    return False


def _self_attr_of_mutation(node: ast.AST) -> tuple[str, int] | None:
    """(attr, lineno) when `node` mutates a self attribute: assignment to
    self.X / self.X[...], augmented assignment, or a mutating method call
    self.X.append(...)."""
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = (
            node.targets if isinstance(node, ast.Assign) else [node.target]
        )
        for t in targets:
            base = t
            if isinstance(base, ast.Subscript):
                key = dataflow.keyed_dict_attr(base)
                if key is not None:
                    return key, node.lineno
                base = base.value
            if (
                isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"
            ):
                return base.attr, node.lineno
    elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr in _MUTATORS:
            owner = node.func.value
            if isinstance(owner, ast.Subscript):
                key = dataflow.keyed_dict_attr(owner)
                if key is not None:
                    return key, node.lineno
                owner = owner.value
            if (
                isinstance(owner, ast.Attribute)
                and isinstance(owner.value, ast.Name)
                and owner.value.id == "self"
            ):
                return owner.attr, node.lineno
    return None


def _walk_mutations(node: ast.AST, locks: set, in_lock: bool, acc: list):
    """(attr, lineno, under_lock) for every self-attr mutation under
    `node`, tracking lock context through nested statements and defs."""
    for child in ast.iter_child_nodes(node):
        child_in_lock = in_lock or (
            isinstance(child, ast.With) and _is_lock_with(child, locks)
        )
        mut = _self_attr_of_mutation(child)
        if mut is not None:
            acc.append((mut[0], mut[1], child_in_lock))
        _walk_mutations(child, locks, child_in_lock, acc)


def check(ctx: Context) -> list[Violation]:
    out: list[Violation] = []
    for sf in ctx.scoped(SCOPE):
        for cls in dataflow.get_index(ctx).walk(sf):
            if not isinstance(cls, ast.ClassDef):
                continue
            locks = _lock_attrs(cls)
            if not locks:
                continue
            # method name -> [(attr, line, under_lock)]
            per_method: dict[str, list] = {}
            for item in cls.body:
                if not isinstance(
                    item, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                acc: list = []
                _walk_mutations(item, locks, False, acc)
                per_method[item.name] = acc
            guarded = {
                attr
                for muts in per_method.values()
                for attr, _, under in muts
                if under
            } - locks
            if not guarded:
                continue
            for method, muts in per_method.items():
                if method == "__init__":
                    continue
                for attr, line, under in muts:
                    if attr in guarded and not under:
                        out.append(
                            Violation(
                                RULE, sf.path, line,
                                f"{cls.name}.{method} mutates `self.{attr}` "
                                "without the lock that guards it elsewhere "
                                "in this class",
                            )
                        )
    return out
