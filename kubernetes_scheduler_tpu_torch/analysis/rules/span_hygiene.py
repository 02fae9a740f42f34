"""span-hygiene: emitted span (stage) names are registered, well-formed,
and never removed once shipped.

Span names became an API the moment `spans report` grew an attribution
table: the per-stage budget rows, `spans diff`'s regression gate, the
Grafana panels over stage latencies, and Perfetto bookmarks all
reference stages by NAME, long after the emitting code was refactored —
exactly the contract metric names acquired in the metric-hygiene
family, applied to the span layer. Checked in every in-scope file:

- **Name shape** — every emitted name is a non-empty
  `lower_snake_case` identifier (a renamed or typo'd stage silently
  drops out of every report keyed on the old name).
- **The shipped registry** — a `SHIPPED_SPANS` tuple
  (host/observe.py) pins every stage name ever emitted. An emitted
  name missing from the registry is flagged (adding a stage is a
  conscious, reviewable act: the attribution table and dashboards need
  to know about it); a registered name no longer emitted anywhere is
  flagged (a removed stage silently zeroes the budget row and every
  `spans diff` baseline that references it). Registry checks only run
  when a SHIPPED_SPANS declaration is in scope (fixture files carry
  their own). A `*NAME` element includes the string tuple assigned to
  NAME in the same file (the port's PORT_SPANS).

Emission sites the rule understands (the package's only span surfaces):
`<x>._span("name", ...)` (Scheduler's per-cycle helper),
`<x>.add("name", t0, t1, ...)` (SpanSet.add — three or more positional
args, which keeps ordinary `set.add(value)` calls out of scope), and
`<x>.span("name")` (SpanSet's context manager).
"""

from __future__ import annotations

import ast
import re

from kubernetes_scheduler_tpu_torch.analysis import dataflow
from kubernetes_scheduler_tpu_torch.analysis.core import Context, Violation

RULE = "span-hygiene"

SCOPE = ("kubernetes_scheduler_tpu_torch/**/*.py", "kubernetes_scheduler_tpu_torch/*.py")

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")


def _const_str(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _emitted_name(call: ast.Call) -> str | None:
    """The span name a call emits, or None when the call is not a span
    emission site. `.add` needs >= 3 positional args (name, t0, t1) so
    `set.add(x)` / protobuf `repeated.add(...)` never match."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    if fn.attr == "_span" and call.args:
        return _const_str(call.args[0])
    if fn.attr == "add" and len(call.args) >= 3:
        return _const_str(call.args[0])
    if fn.attr == "span" and call.args:
        return _const_str(call.args[0])
    return None


def _string_tuples(nodes) -> dict:
    """{NAME: [(element node, string)]} of every `NAME = (...)` tuple or
    list assignment among `nodes`, string elements only."""
    out: dict = {}
    for node in nodes:
        if isinstance(node, ast.Assign) and isinstance(
            node.value, (ast.Tuple, ast.List)
        ):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = [
                        (el, _const_str(el)) for el in node.value.elts
                        if _const_str(el) is not None
                    ]
    return out


def _elements(elts, tuples: dict) -> list:
    """(node, string) per registry element, `*NAME` expanded through
    `tuples`."""
    out = []
    for el in elts:
        if isinstance(el, ast.Starred) and isinstance(el.value, ast.Name):
            out.extend(tuples.get(el.value.id, ()))
        else:
            out.append((el, _const_str(el)))
    return out


def check(ctx: Context) -> list[Violation]:
    out: list[Violation] = []
    # name -> (path, line) of the first emission site
    emitted: dict[str, tuple] = {}
    # (path, line, names) per SHIPPED_SPANS declaration
    registries: list[tuple] = []

    for sf in ctx.scoped(SCOPE):
        nodes = list(dataflow.get_index(ctx).walk(sf))
        tuples = _string_tuples(nodes)
        for node in nodes:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Name)
                        and t.id == "SHIPPED_SPANS"
                        and isinstance(node.value, (ast.Tuple, ast.List))
                    ):
                        names = []
                        seen: set[str] = set()
                        for el, s in _elements(node.value.elts, tuples):
                            if s is None:
                                continue
                            if s in seen:
                                out.append(Violation(
                                    RULE, sf.path, el.lineno,
                                    f"span `{s}` registered twice in "
                                    "SHIPPED_SPANS",
                                ))
                            seen.add(s)
                            names.append(s)
                        registries.append((sf.path, node.lineno, names))
            elif isinstance(node, ast.Call):
                name = _emitted_name(node)
                if name is None:
                    continue
                if not _NAME_RE.match(name):
                    out.append(Violation(
                        RULE, sf.path, node.lineno,
                        f"span name {name!r} is not lower_snake_case — "
                        "reports and dashboards key stages by name, so "
                        "names follow one shape",
                    ))
                    continue
                emitted.setdefault(name, (sf.path, node.lineno))

    if registries:
        shipped: dict[str, tuple] = {}
        for path, line, names in registries:
            for n in names:
                shipped.setdefault(n, (path, line))
        for name, (path, line) in sorted(emitted.items()):
            if name not in shipped:
                out.append(Violation(
                    RULE, path, line,
                    f"span `{name}` is not registered in SHIPPED_SPANS "
                    "— append it (and never remove it): `spans report` "
                    "attribution tables and dashboards reference stages "
                    "by name",
                ))
        for name, (path, line) in sorted(shipped.items()):
            if name not in emitted:
                out.append(Violation(
                    RULE, path, line,
                    f"shipped span `{name}` is no longer emitted "
                    "anywhere — a removed stage silently zeroes its "
                    "budget row and every `spans diff` baseline that "
                    "references it",
                ))
    return out
