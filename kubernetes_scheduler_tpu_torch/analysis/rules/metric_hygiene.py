"""metric-hygiene: exported metric names are documented, unit-suffixed,
and never removed once shipped.

Metrics are an API: dashboards, alerts, and the SLO review reference
them by NAME, long after the code that emitted them was refactored. The
reference exported nothing (SURVEY.md §5); now that this scheduler and
its sidecar export real surfaces (host/observe.py `render_prometheus`
gauges + the labeled Histogram/Counter/Gauge layer), the names need the
same schema discipline the wire-schema family gives proto fields and
journal tags. Checked in every in-scope file:

- **HELP coverage** — keys of a `*_HELP` dict literal must carry a
  non-empty help string, and every metric emitted through the runtime
  `extra` side channel (`extra.update(name_total=...)` /
  `extra["name_total"] = ...`) must have a HELP entry declared
  somewhere in scope: render_prometheus falls back to an empty HELP
  line at runtime, but an undocumented metric is a lint failure.
- **Unit suffixes** — every name ends in a unit (`_seconds`, `_bytes`,
  `_per_sec`, ...) or `_total`; `Counter(...)` names must end `_total`
  specifically (Prometheus counter convention).
- **Help text** — `Histogram(...)`/`Counter(...)`/`Gauge(...)`
  constructions must pass a non-empty help string (second positional or
  `help=`).
- **The shipped registry** — a `SHIPPED_METRICS` tuple (observe.py)
  pins every name ever exported. A pinned name no longer declared
  anywhere in scope is flagged (a removed metric silently zeroes
  dashboards); a declared name missing from the registry is flagged so
  adding a metric is a conscious, reviewable act. Registry checks only
  run when a SHIPPED_METRICS declaration is in scope (fixture files
  carry their own).
"""

from __future__ import annotations

import ast

from kubernetes_scheduler_tpu_torch.analysis import dataflow
from kubernetes_scheduler_tpu_torch.analysis.core import Context, Violation

RULE = "metric-hygiene"

SCOPE = ("kubernetes_scheduler_tpu_torch/**/*.py", "kubernetes_scheduler_tpu_torch/*.py")

# the unit vocabulary: `_total` for counters, real units for everything
# else. `_count` covers live-object gauges (resident_sessions_count);
# `_mean`/`_per_sec` are shipped derived-statistic names; `_rung` is
# the degradation ladder's position unit (host/resilience.py — 0 = top).
UNIT_SUFFIXES = (
    "_total", "_seconds", "_bytes", "_ratio", "_per_sec", "_count",
    "_mean", "_info", "_rung",
)

_COLLECTOR_CTORS = {"Histogram", "Counter", "Gauge"}


def _const_str(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _ctor_name(call: ast.Call) -> str | None:
    fn = call.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else None
    )
    return name if name in _COLLECTOR_CTORS else None


def _suffix_ok(name: str) -> bool:
    return any(name.endswith(s) for s in UNIT_SUFFIXES)


def check(ctx: Context) -> list[Violation]:
    out: list[Violation] = []
    # name -> (path, line) of a declaration (HELP key or collector ctor)
    declared: dict[str, tuple] = {}
    # names emitted through the runtime `extra` side channel
    emitted_extra: dict[str, tuple] = {}
    help_keys: set[str] = set()
    # (path, line, tuple_of_names) per SHIPPED_METRICS declaration
    registries: list[tuple] = []

    for sf in ctx.scoped(SCOPE):
        for node in dataflow.get_index(ctx).walk(sf):
            # ---- *_HELP dict literals ---------------------------------
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    tname = t.id if isinstance(t, ast.Name) else None
                    if tname and "HELP" in tname and isinstance(
                        node.value, ast.Dict
                    ):
                        seen: set[str] = set()
                        for k, v in zip(
                            node.value.keys, node.value.values
                        ):
                            key = _const_str(k)
                            if key is None:
                                continue
                            if key in seen:
                                out.append(Violation(
                                    RULE, sf.path, k.lineno,
                                    f"metric `{key}` declared twice in "
                                    f"{tname}",
                                ))
                            seen.add(key)
                            help_keys.add(key)
                            declared.setdefault(
                                key, (sf.path, k.lineno)
                            )
                            if not _suffix_ok(key):
                                out.append(Violation(
                                    RULE, sf.path, k.lineno,
                                    f"metric `{key}` has no unit suffix "
                                    f"— names must end in one of "
                                    f"{UNIT_SUFFIXES}",
                                ))
                            text = _const_str(v)
                            if not text:
                                out.append(Violation(
                                    RULE, sf.path, k.lineno,
                                    f"metric `{key}` has an empty HELP "
                                    "string — document what the number "
                                    "means",
                                ))
                    if (
                        tname == "SHIPPED_METRICS"
                        and isinstance(node.value, (ast.Tuple, ast.List))
                    ):
                        names = tuple(
                            s
                            for el in node.value.elts
                            if (s := _const_str(el)) is not None
                        )
                        registries.append((sf.path, node.lineno, names))
                # extra["name"] = ... (the exporter side channel)
                for t in node.targets:
                    if (
                        isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "extra"
                    ):
                        key = _const_str(t.slice)
                        if key is not None:
                            emitted_extra.setdefault(
                                key, (sf.path, t.lineno)
                            )

            # ---- collector constructions ------------------------------
            elif isinstance(node, ast.Call):
                ctor = _ctor_name(node)
                if ctor is not None and node.args:
                    name = _const_str(node.args[0])
                    if name is None:
                        continue
                    declared.setdefault(name, (sf.path, node.lineno))
                    if ctor == "Counter" and not name.endswith("_total"):
                        out.append(Violation(
                            RULE, sf.path, node.lineno,
                            f"Counter `{name}` must end in `_total` "
                            "(Prometheus counter convention)",
                        ))
                    elif not _suffix_ok(name):
                        out.append(Violation(
                            RULE, sf.path, node.lineno,
                            f"{ctor} `{name}` has no unit suffix — "
                            f"names must end in one of {UNIT_SUFFIXES}",
                        ))
                    help_arg = None
                    if len(node.args) > 1:
                        help_arg = node.args[1]
                    else:
                        for kw in node.keywords:
                            if kw.arg == "help":
                                help_arg = kw.value
                    if help_arg is None or not _const_str(help_arg):
                        out.append(Violation(
                            RULE, sf.path, node.lineno,
                            f"{ctor} `{name}` has no (or an empty) help "
                            "string — document what the number means",
                        ))
                # extra.update(name_total=...)
                fn = node.func
                if (
                    isinstance(fn, ast.Attribute)
                    and fn.attr == "update"
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id == "extra"
                ):
                    for kw in node.keywords:
                        if kw.arg is not None:
                            emitted_extra.setdefault(
                                kw.arg, (sf.path, node.lineno)
                            )

    # ---- cross-file contracts ---------------------------------------
    for name, (path, line) in sorted(emitted_extra.items()):
        if name not in help_keys:
            out.append(Violation(
                RULE, path, line,
                f"metric `{name}` is emitted through `extra` but has no "
                "HELP entry in any *_HELP table in scope",
            ))
        if not _suffix_ok(name):
            out.append(Violation(
                RULE, path, line,
                f"metric `{name}` has no unit suffix — names must end "
                f"in one of {UNIT_SUFFIXES}",
            ))

    if registries:
        shipped: dict[str, tuple] = {}
        for path, line, names in registries:
            for n in names:
                shipped.setdefault(n, (path, line))
        all_known = dict(declared)
        for n, where in emitted_extra.items():
            all_known.setdefault(n, where)
        for name, (path, line) in sorted(shipped.items()):
            if name not in all_known:
                out.append(Violation(
                    RULE, path, line,
                    f"shipped metric `{name}` is no longer declared "
                    "anywhere — a removed metric silently zeroes every "
                    "dashboard and alert that references it",
                ))
        for name, (path, line) in sorted(all_known.items()):
            if name not in shipped:
                out.append(Violation(
                    RULE, path, line,
                    f"metric `{name}` is not registered in "
                    "SHIPPED_METRICS — append it (and never remove it)",
                ))
    return out
