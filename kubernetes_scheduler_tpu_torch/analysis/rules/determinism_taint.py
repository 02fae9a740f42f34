"""Nondeterminism must never reach replay-pinned outputs: wall/perf
clock reads (`time.time`, `time.perf_counter`, `datetime.now` — outside
the injected-clock and span plumbing), iteration order of `set`s
(`list(s)`, comprehensions, bare `for` over a set — `sorted()` is the
discharge), and `id()`-keyed ordering are TAINT SOURCES; journal record
fields (`record_cycle`/`encode_record` arguments, record-dict literals),
`SnapshotDelta`/`CycleMetrics` construction, and engine operands are
SINKS. Declared timing telemetry (`*_seconds`, `wall_time`) is the
sanctioned wall-clock surface; everything else must be a function of
the seed — the bitwise-replay precondition `sim-determinism` enforces
for RNG, extended to clocks and ordering, repo-wide."""

from __future__ import annotations

import ast

from kubernetes_scheduler_tpu_torch.analysis.core import Violation, dotted_name
from kubernetes_scheduler_tpu_torch.analysis import dataflow

RULE = "determinism-taint"

WALL_CLOCKS = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow",
}

# journal fields DECLARED to carry wall/duration telemetry: replay pins
# bindings/operands, not these (trace diff compares decision fields).
# `seconds` is the bench-row walltime column the sim drivers stamp.
_TIMING_FIELDS = ("wall_time", "seconds")


def _timing_field(name: str) -> bool:
    return (
        name in _TIMING_FIELDS
        or name.endswith("_seconds")
        or name.endswith("_ts")
    )


# constructing one of these is a replay-pinned sink in every module
_CTOR_SINKS = {"SnapshotDelta", "CycleMetrics"}
# calls whose arguments land in the journal
_RECORD_CALLS = ("record_cycle", "encode_record")
# engine entry points: operands must be deterministic
_ENGINE_SINKS = {
    "schedule_batch", "schedule_windows", "apply_snapshot_delta",
    "apply_layout_delta", "build_fused_layout",
}

_SET_CTORS = {"set", "frozenset"}


class _FnTaint:
    """Function-local taint: kinds are 'wall-clock', 'set-order',
    'id-order'. `summaries` maps project qnames to their return-taint
    kinds (interprocedural fixpoint, resolved through the shared call
    graph)."""

    def __init__(self, index, fi, class_set_attrs, summaries):
        self.index = index
        self.fi = fi
        self.class_set_attrs = class_set_attrs
        self.summaries = summaries
        self.local_kinds: dict[str, set[str]] = {}
        self.set_locals: set[str] = set()
        self.metrics_locals: set[str] = set()
        self.record_dicts: set[str] = set()

    # -- expression classification --

    def is_set_expr(self, node) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            dn = dotted_name(node.func)
            if dn and dn.rsplit(".", 1)[-1] in _SET_CTORS:
                return True
        if isinstance(node, ast.Name):
            return node.id in self.set_locals
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return node.attr in self.class_set_attrs
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr, ast.Sub, ast.BitXor)
        ):
            return self.is_set_expr(node.left) or self.is_set_expr(node.right)
        return False

    def taint(self, node) -> set[str]:
        """Taint kinds of an expression (empty set = deterministic)."""
        if node is None:
            return set()
        if isinstance(node, ast.Call):
            dn = dotted_name(node.func)
            name = dn.rsplit(".", 1)[-1] if dn else None
            if dn in WALL_CLOCKS:
                return {"wall-clock"}
            if name == "id":
                return {"id-order"}
            if name == "sorted":
                # the discharge — unless the order key itself is id()
                for kw in node.keywords:
                    if kw.arg == "key" and "id" in (
                        dotted_name(kw.value) or ""
                    ).split("."):
                        return {"id-order"}
                return set()
            if name in ("list", "tuple") and node.args:
                if self.is_set_expr(node.args[0]):
                    return {"set-order"}
                return self.taint(node.args[0])
            if name in ("pop",) and isinstance(node.func, ast.Attribute):
                if self.is_set_expr(node.func.value) and not node.args:
                    return {"set-order"}
            # project calls: return-taint summaries
            out: set[str] = set()
            for cand in self.index.resolve_call(self.fi, node):
                out |= self.summaries.get(cand.qname, set())
            for a in list(node.args) + [k.value for k in node.keywords]:
                if name in ("min", "max", "sum", "len", "sorted", "any",
                            "all", "set", "frozenset"):
                    break  # order-insensitive folds launder set-order
                out |= self.taint(a)
            return out
        if isinstance(node, ast.Name):
            return set(self.local_kinds.get(node.id, ()))
        if isinstance(node, ast.BinOp):
            return self.taint(node.left) | self.taint(node.right)
        if isinstance(node, (ast.List, ast.Tuple)):
            out = set()
            for e in node.elts:
                out |= self.taint(e)
            return out
        if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            out = set()
            for gen in node.generators:
                if self.is_set_expr(gen.iter):
                    out.add("set-order")
                out |= self.taint(gen.iter)
            out |= self.taint(node.elt)
            return out
        if isinstance(node, ast.IfExp):
            return self.taint(node.body) | self.taint(node.orelse)
        if isinstance(node, ast.Starred):
            return self.taint(node.value)
        if isinstance(node, ast.Subscript):
            return self.taint(node.value)
        if isinstance(node, ast.UnaryOp):
            return self.taint(node.operand)
        return set()

    # -- statement pass (run to a small fixpoint so later-defined
    #    locals feed earlier uses across loop iterations) --

    def seed_locals(self) -> None:
        for _ in range(2):
            for node in dataflow.shallow_walk(self.fi.node):
                if isinstance(node, ast.Assign):
                    kinds = self.taint(node.value)
                    is_set = self.is_set_expr(node.value)
                    is_metrics = (
                        isinstance(node.value, ast.Call)
                        and (dotted_name(node.value.func) or "").rsplit(
                            ".", 1
                        )[-1] == "CycleMetrics"
                    )
                    is_rec = isinstance(node.value, ast.Dict)
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            if kinds:
                                self.local_kinds.setdefault(
                                    t.id, set()
                                ).update(kinds)
                            if is_set:
                                self.set_locals.add(t.id)
                            if is_metrics:
                                self.metrics_locals.add(t.id)
                            if is_rec:
                                self.record_dicts.add(t.id)
                        elif isinstance(t, ast.Tuple) and kinds:
                            # a, b = tainted_call(): taint every name
                            for elt in t.elts:
                                if isinstance(elt, ast.Name):
                                    self.local_kinds.setdefault(
                                        elt.id, set()
                                    ).update(kinds)
                elif isinstance(node, ast.AugAssign) and isinstance(
                    node.target, ast.Name
                ):
                    kinds = self.taint(node.value)
                    if kinds:
                        self.local_kinds.setdefault(
                            node.target.id, set()
                        ).update(kinds)
                elif isinstance(node, ast.For):
                    if self.is_set_expr(node.iter) and isinstance(
                        node.target, ast.Name
                    ):
                        self.local_kinds.setdefault(
                            node.target.id, set()
                        ).add("set-order")
                    it_kinds = self.taint(node.iter)
                    if it_kinds and isinstance(node.target, ast.Name):
                        self.local_kinds.setdefault(
                            node.target.id, set()
                        ).update(it_kinds)
                elif isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute
                ):
                    # L.append(tainted) taints the accumulator list
                    if node.func.attr in ("append", "extend", "add") \
                            and isinstance(node.func.value, ast.Name):
                        kinds = set()
                        for a in node.args:
                            kinds |= self.taint(a)
                        if kinds:
                            self.local_kinds.setdefault(
                                node.func.value.id, set()
                            ).update(kinds)

    def return_kinds(self) -> set[str]:
        out: set[str] = set()
        for node in dataflow.shallow_walk(self.fi.node):
            if isinstance(node, ast.Return):
                out |= self.taint(node.value)
        return out


def _class_set_attrs(index) -> dict[str, set[str]]:
    """class key -> attrs assigned `set()`/set literals anywhere in the
    class (the mirror's dirty-row sets)."""
    out: dict[str, set[str]] = {}
    for fi in index.funcs.values():
        if fi.cls is None:
            continue
        key = f"{fi.sf.path}::{fi.cls.name}"
        for node in dataflow.shallow_walk(fi.node):
            if isinstance(node, ast.Assign):
                is_set = isinstance(node.value, (ast.Set, ast.SetComp)) or (
                    isinstance(node.value, ast.Call)
                    and (dotted_name(node.value.func) or "").rsplit(".", 1)[-1]
                    in _SET_CTORS
                )
                if not is_set:
                    continue
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        out.setdefault(key, set()).add(t.attr)
    return out


def _summaries(index, set_attrs) -> dict[str, set[str]]:
    """Return-taint fixpoint over the project call graph (two passes
    reach every realistic helper chain)."""
    summaries: dict[str, set[str]] = {}
    for _ in range(2):
        changed = False
        for qname, fi in index.funcs.items():
            owner = (
                f"{fi.sf.path}::{fi.cls.name}" if fi.cls is not None else None
            )
            ft = _FnTaint(
                index, fi, set_attrs.get(owner, set()), summaries
            )
            ft.seed_locals()
            kinds = ft.return_kinds()
            if kinds - summaries.get(qname, set()):
                summaries[qname] = summaries.get(qname, set()) | kinds
                changed = True
        if not changed:
            break
    return summaries


def _kind_hint(kinds: set[str]) -> str:
    hints = {
        "wall-clock": (
            "inject the clock (a `clock=` parameter / `self._clock`) so "
            "replay can pin it, or route the value to a declared timing "
            "field (`*_seconds`, `wall_time`)"
        ),
        "set-order": "materialize with `sorted(...)` before it escapes",
        "id-order": (
            "key on a stable identity (name/uid/index), never `id()`"
        ),
    }
    return "; ".join(hints[k] for k in sorted(kinds))


def check(ctx) -> list[Violation]:
    index = dataflow.get_index(ctx)
    set_attrs = _class_set_attrs(index)
    summaries = _summaries(index, set_attrs)
    out: list[Violation] = []
    for sf in ctx.files:
        for fi in index.functions(sf):
            owner = (
                f"{fi.sf.path}::{fi.cls.name}" if fi.cls is not None else None
            )
            ft = _FnTaint(
                index, fi, set_attrs.get(owner, set()), summaries
            )
            ft.seed_locals()
            in_recorder = "record" in fi.name or "journal" in fi.name
            for node in dataflow.shallow_walk(fi.node):
                if isinstance(node, ast.Call):
                    dn = dotted_name(node.func) or ""
                    name = dn.rsplit(".", 1)[-1]
                    if name in _CTOR_SINKS:
                        for kw in node.keywords:
                            kinds = ft.taint(kw.value)
                            if kinds and not _timing_field(kw.arg or ""):
                                out.append(Violation(
                                    RULE, sf.path, node.lineno,
                                    f"{'/'.join(sorted(kinds))} value "
                                    f"flows into `{name}({kw.arg}=...)` "
                                    "— a replay-pinned operand must be "
                                    "deterministic given the seed; "
                                    f"{_kind_hint(kinds)}",
                                ))
                        for i, a in enumerate(node.args):
                            kinds = ft.taint(a)
                            if kinds:
                                out.append(Violation(
                                    RULE, sf.path, node.lineno,
                                    f"{'/'.join(sorted(kinds))} value "
                                    f"flows into `{name}(...)` arg {i} "
                                    "— a replay-pinned operand must be "
                                    "deterministic given the seed; "
                                    f"{_kind_hint(kinds)}",
                                ))
                    elif name in _ENGINE_SINKS or any(
                        r in name for r in _RECORD_CALLS
                    ):
                        sink_kind = (
                            "journal record field"
                            if any(r in name for r in _RECORD_CALLS)
                            else "engine operand"
                        )
                        args = list(node.args) + [
                            k.value for k in node.keywords
                            if not _timing_field(k.arg or "")
                        ]
                        for a in args:
                            kinds = ft.taint(a)
                            if isinstance(a, ast.Name) and (
                                a.id in ft.record_dicts
                            ):
                                continue  # dict literals audited below
                            if kinds:
                                out.append(Violation(
                                    RULE, sf.path, node.lineno,
                                    f"{'/'.join(sorted(kinds))} value "
                                    f"reaches `{name}(...)` — a "
                                    f"{sink_kind} must be deterministic "
                                    "given the seed; "
                                    f"{_kind_hint(kinds)}",
                                ))
                elif isinstance(node, ast.Assign):
                    # record-dict / CycleMetrics field stores
                    for t in node.targets:
                        if (
                            isinstance(t, ast.Subscript)
                            and isinstance(t.value, ast.Name)
                            and t.value.id in ft.record_dicts
                            and isinstance(t.slice, ast.Constant)
                            and isinstance(t.slice.value, str)
                        ):
                            fieldname = t.slice.value
                            kinds = ft.taint(node.value)
                            if kinds and not _timing_field(fieldname):
                                out.append(Violation(
                                    RULE, sf.path, node.lineno,
                                    f"{'/'.join(sorted(kinds))} value "
                                    "stamped into journal-record field "
                                    f"`{fieldname}` — replay pins "
                                    "record fields; declared timing "
                                    "fields (`wall_time`, `*_seconds`) "
                                    "are the sanctioned surface; "
                                    f"{_kind_hint(kinds)}",
                                ))
                        elif (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id in ft.metrics_locals
                        ):
                            kinds = ft.taint(node.value)
                            if kinds and not _timing_field(t.attr):
                                out.append(Violation(
                                    RULE, sf.path, node.lineno,
                                    f"{'/'.join(sorted(kinds))} value "
                                    "assigned to journaled CycleMetrics "
                                    f"field `{t.attr}` — only timing "
                                    "fields (`*_seconds`) may carry "
                                    "clock-derived values; "
                                    f"{_kind_hint(kinds)}",
                                ))
                    # dict-literal record construction inside recorder-
                    # shaped functions (or dicts that flow to a record
                    # call): audit the literal's fields
                    if isinstance(node.value, ast.Dict):
                        is_record = in_recorder or any(
                            isinstance(t, ast.Name)
                            and t.id in ft.record_dicts
                            for t in node.targets
                        )
                        if is_record:
                            for k, v in zip(
                                node.value.keys, node.value.values
                            ):
                                if not (
                                    isinstance(k, ast.Constant)
                                    and isinstance(k.value, str)
                                ):
                                    continue
                                kinds = ft.taint(v)
                                if kinds and not _timing_field(k.value):
                                    out.append(Violation(
                                        RULE, sf.path, v.lineno,
                                        f"{'/'.join(sorted(kinds))} "
                                        "value stamped into journal-"
                                        f"record field `{k.value}` — "
                                        "replay pins record fields; "
                                        "declared timing fields "
                                        "(`wall_time`, `*_seconds`) are "
                                        "the sanctioned surface; "
                                        f"{_kind_hint(kinds)}",
                                    ))
    return out
