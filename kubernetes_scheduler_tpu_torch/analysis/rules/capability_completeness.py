"""capability-completeness: every HealthReply capability bit is wired
end to end, and every RPC failure path invalidates the session.

A capability bit that exists in the proto but is only half-wired is the
version-skew bug factory: a bit the client probes but never invalidates
survives a mid-stream downgrade (the PR-3 class); a bit the server
never answers reads as permanently absent; a latch without a supports_*
accessor gates nothing. The contract, pinned here against
bridge/schedule.proto in BOTH directions:

- the client's `CAPABILITY_LATCHES` table names exactly the HealthReply
  bool fields, `_probe_capabilities` and `_invalidate_session` are
  table-driven (one probe resolves the set, one failure drops the set),
  and every latch attribute is read by at least one accessor method —
  a latch nobody reads gates nothing;
- the server's `CAPABILITY_SWITCHES` table names exactly the same
  fields, `health` renders through it, and every switch attribute is
  assigned in the class (a missing assignment would make Health raise
  — or worse, getattr-default its way to False);
- every method that sends through `self._call_with_retry` directly
  must reference `_invalidate_session` — the except-path discipline
  `_call_cached` implements, required of EVERY RPC surface (the
  Preempt path historically skipped it).

The table-driven shape is what makes the NEXT capability bit cheap:
add the proto field, one entry per table, one switch default, one
accessor — this family fails the build until all four exist, and the
parametrized downgrade regression tests pick the new entry up for
free. The probe/invalidate PROTOCOL itself (all-or-nothing latch
discipline under restart/downgrade interleavings) is model-checked by
the JAX package's analysis/model/ (the port's protocol models are a
later slice); this family is the static side: the wiring exists.
"""

from __future__ import annotations

import ast

from kubernetes_scheduler_tpu_torch.analysis.core import (
    Context,
    Violation,
)
from kubernetes_scheduler_tpu_torch.analysis.rules.wire_schema import (
    _proto_for,
    parse_proto_fields,
)

RULE = "capability-completeness"

SCOPE = (
    "kubernetes_scheduler_tpu_torch/bridge/client.py",
    "kubernetes_scheduler_tpu_torch/bridge/server.py",
)

_LATCH_TABLE = "CAPABILITY_LATCHES"
_SWITCH_TABLE = "CAPABILITY_SWITCHES"

_HEALTH_MSG = "HealthReply"


def health_bool_fields(proto_path: str) -> set[str]:
    """The bool fields of message HealthReply — the capability bits
    (wire_schema's one proto tokenizer, filtered on declared type)."""
    fields = parse_proto_fields(proto_path).get(_HEALTH_MSG, {})
    return {name for name, ftype in fields.items() if ftype == "bool"}


def _dict_literal(sf, name: str):
    """(lineno, {key: value}) for a module-level `name = {...}` of
    string constants, or None."""
    for node in sf.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == name for t in node.targets
        ):
            continue
        if not isinstance(node.value, ast.Dict):
            return node.lineno, None
        table = {}
        for k, v in zip(node.value.keys, node.value.values):
            if isinstance(k, ast.Constant) and isinstance(v, ast.Constant):
                table[str(k.value)] = str(v.value)
        return node.lineno, table
    return None


def _refs_name(fn: ast.AST, name: str) -> bool:
    """Does the CODE of `fn` reference `name`? AST-based, so a
    docstring or comment that merely MENTIONS the table cannot satisfy
    the check (the verify drive caught exactly that false negative:
    seeding the PR-3 bug left the docstring's table mention behind)."""
    return any(
        isinstance(n, ast.Name) and n.id == name for n in ast.walk(fn)
    )


def _refs_attr_of_self(fn: ast.AST, attr: str, *, ctx: type | None = None) -> bool:
    """Does `fn` access `self.<attr>`? `ctx=ast.Load` restricts to
    reads (a write-only reference is not an accessor), `ast.Store` to
    assignments."""
    for n in ast.walk(fn):
        if (
            isinstance(n, ast.Attribute)
            and n.attr == attr
            and isinstance(n.value, ast.Name)
            and n.value.id == "self"
            and (ctx is None or isinstance(n.ctx, ctx))
        ):
            return True
    return False


def _calls_self_method(fn: ast.AST, method: str) -> bool:
    for n in ast.walk(fn):
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == method
            and isinstance(n.func.value, ast.Name)
            and n.func.value.id == "self"
        ):
            return True
    return False


def _reaches_invalidate(fn: ast.AST) -> bool:
    """Any CODE reference to `_invalidate_session` (call or handler)."""
    for n in ast.walk(fn):
        if isinstance(n, ast.Attribute) and n.attr == "_invalidate_session":
            return True
        if isinstance(n, ast.Name) and n.id == "_invalidate_session":
            return True
    return False


def _methods(cls: ast.ClassDef):
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield item


def _class_with(sf, method_name: str) -> ast.ClassDef | None:
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ClassDef) and any(
            m.name == method_name for m in _methods(node)
        ):
            return node
    return None


def _check_table_vs_proto(sf, lineno, table, fields, what, out):
    for missing in sorted(fields - set(table)):
        out.append(Violation(
            RULE, sf.path, lineno,
            f"HealthReply bool `{missing}` is missing from {what} — a "
            "capability bit that is not in the table is never "
            f"{'latched/invalidated' if what == _LATCH_TABLE else 'advertised'}",
        ))
    for ghost in sorted(set(table) - fields):
        out.append(Violation(
            RULE, sf.path, lineno,
            f"{what} entry `{ghost}` names no HealthReply bool field — "
            "stale table entry (field renamed or removed in the proto?)",
        ))


def _check_client(sf, fields, out) -> None:
    hit = _dict_literal(sf, _LATCH_TABLE)
    if hit is None:
        out.append(Violation(
            RULE, sf.path, 1,
            f"bridge client module defines no {_LATCH_TABLE} table — "
            "capability latches must be declared in the one canonical "
            "table (probe/invalidate/tests all key off it)",
        ))
        return
    lineno, table = hit
    if table is None:
        out.append(Violation(
            RULE, sf.path, lineno,
            f"{_LATCH_TABLE} must be a literal dict of str -> str "
            "(proto field -> latch attribute)",
        ))
        return
    _check_table_vs_proto(sf, lineno, table, fields, _LATCH_TABLE, out)
    cls = _class_with(sf, "_invalidate_session")
    if cls is None:
        out.append(Violation(
            RULE, sf.path, lineno,
            "no class with `_invalidate_session` found beside "
            f"{_LATCH_TABLE} — the latch table has no consumer",
        ))
        return
    methods = {m.name: m for m in _methods(cls)}
    for fn_name in ("_probe_capabilities", "_invalidate_session"):
        fn = methods.get(fn_name)
        if fn is None:
            out.append(Violation(
                RULE, sf.path, cls.lineno,
                f"class {cls.name} has no `{fn_name}` — every capability "
                "latch must be probed and invalidated through the shared "
                "path",
            ))
        elif not _refs_name(fn, _LATCH_TABLE):
            out.append(Violation(
                RULE, sf.path, fn.lineno,
                f"`{cls.name}.{fn_name}` does not iterate "
                f"{_LATCH_TABLE} — a hand-rolled latch list WILL drift "
                "from the table the next time a bit is added (the PR-3 "
                "invalidate-together bug class)",
            ))
    # every latch needs an accessor: some method beyond the shared
    # probe/invalidate/init must READ the attribute, else nothing is
    # actually gated on the capability
    plumbing = {"_probe_capabilities", "_invalidate_session", "__init__"}
    for fieldname, attr in sorted(table.items()):
        readers = [
            m.name for m in _methods(cls)
            if m.name not in plumbing
            and _refs_attr_of_self(m, attr, ctx=ast.Load)
        ]
        if not readers:
            out.append(Violation(
                RULE, sf.path, lineno,
                f"latch `{attr}` (HealthReply.{fieldname}) has no "
                "accessor — no method outside the probe/invalidate "
                "plumbing reads it, so the capability gates nothing",
            ))
    # except-path discipline: a direct _call_with_retry sender must
    # reach _invalidate_session (directly or via its handlers)
    for m in _methods(cls):
        if m.name in ("_call_with_retry", "_invalidate_session"):
            continue
        if _calls_self_method(m, "_call_with_retry") and not \
                _reaches_invalidate(m):
            out.append(Violation(
                RULE, sf.path, m.lineno,
                f"`{cls.name}.{m.name}` sends through _call_with_retry "
                "but never reaches `_invalidate_session` — a failed RPC "
                "on this surface would leave the wire field cache and "
                "the capability latches trusting a sidecar that may "
                "have been replaced",
            ))


def _check_server(sf, fields, out) -> None:
    hit = _dict_literal(sf, _SWITCH_TABLE)
    if hit is None:
        out.append(Violation(
            RULE, sf.path, 1,
            f"bridge server module defines no {_SWITCH_TABLE} table — "
            "capability switches must be declared in the one canonical "
            "table health() renders through",
        ))
        return
    lineno, table = hit
    if table is None:
        out.append(Violation(
            RULE, sf.path, lineno,
            f"{_SWITCH_TABLE} must be a literal dict of str -> str "
            "(proto field -> switch attribute)",
        ))
        return
    _check_table_vs_proto(sf, lineno, table, fields, _SWITCH_TABLE, out)
    cls = _class_with(sf, "health")
    if cls is None:
        out.append(Violation(
            RULE, sf.path, lineno,
            "no class with a `health` method found beside "
            f"{_SWITCH_TABLE} — the switch table has no renderer",
        ))
        return
    health = next(m for m in _methods(cls) if m.name == "health")
    if not _refs_name(health, _SWITCH_TABLE):
        out.append(Violation(
            RULE, sf.path, health.lineno,
            f"`{cls.name}.health` does not render through "
            f"{_SWITCH_TABLE} — a bit added to the table would never "
            "reach the wire",
        ))
    for fieldname, attr in sorted(table.items()):
        if not _refs_attr_of_self(cls, attr, ctx=ast.Store):
            out.append(Violation(
                RULE, sf.path, lineno,
                f"switch `{attr}` (HealthReply.{fieldname}) is never "
                f"assigned in class {cls.name} — health() would raise "
                "(or default) instead of advertising a real capability",
            ))


def check(ctx: Context) -> list[Violation]:
    out: list[Violation] = []
    for sf in ctx.scoped(SCOPE):
        has_latches = _dict_literal(sf, _LATCH_TABLE) is not None
        has_switches = _dict_literal(sf, _SWITCH_TABLE) is not None
        if ctx.explicit and not (has_latches or has_switches):
            continue  # fixture mode: only capability-shaped modules
        proto = _proto_for(ctx, sf)
        if proto is None:
            continue
        fields = health_bool_fields(proto)
        is_client = has_latches or sf.path.endswith("bridge/client.py")
        is_server = has_switches or sf.path.endswith("bridge/server.py")
        if is_client:
            _check_client(sf, fields, out)
        if is_server:
            _check_server(sf, fields, out)
    return out
