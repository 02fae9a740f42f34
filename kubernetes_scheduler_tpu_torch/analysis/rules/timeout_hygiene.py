"""timeout-hygiene: external calls carry explicit timeout policies.

The host loop's degradation story (ADVICE/SURVEY: advisor outage
requeues the window, sidecar outage flips one cycle to scalar) only
works if nothing in the cycle path can block forever. Flagged across the
whole package:

- `urllib.request.urlopen(...)` without a `timeout=`;
- `subprocess.run/call/check_call/check_output/Popen.communicate(...)`
  without a `timeout=`;
- zero-argument `.wait()` — a threading.Event / grpc event wait with no
  timeout blocks a thread unboundedly on a peer that may never signal
  (`wait_for_termination` serve loops are intentionally unbounded and
  not flagged);
- zero-argument `.join()` on thread-like receivers (name contains
  "thread") — joining a wedged worker hangs shutdown.
- broad exception SWALLOWS on boundary calls: a `try` whose body makes
  an external call (a `timeout=`-bearing call, urlopen, subprocess)
  guarded by a bare `except:` / `except Exception:` handler that
  neither re-raises, nor counts a metric (`.inc`/`.observe`/a counter
  `+=`), nor feeds the circuit breaker
  (`record_failure`/`record_success`, host/resilience.py). A silent
  swallow at a boundary is how an outage stays invisible: the call
  keeps timing out, nothing trips the breaker, no dashboard moves —
  the `RemoteEngine.healthy()` class of bug. Handlers that account
  for the failure (or narrow catches like `grpc.RpcError` routed into
  classification) pass.
"""

from __future__ import annotations

import ast

from kubernetes_scheduler_tpu_torch.analysis import dataflow
from kubernetes_scheduler_tpu_torch.analysis.core import (
    Context,
    Violation,
    dotted_name,
    has_kwarg,
)

RULE = "timeout-hygiene"

SCOPE = ("kubernetes_scheduler_tpu_torch/**/*.py", "kubernetes_scheduler_tpu_torch/*.py")

_SUBPROCESS = {
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output",
}

# handler calls that COUNT as accounting for a boundary failure: metric
# emission and circuit-breaker feeds (host/resilience.CircuitBreaker)
_ACCOUNTING_CALLS = {"inc", "observe", "record_failure", "record_success"}


def _is_boundary_call(node: ast.Call) -> bool:
    """An external call: carries an explicit timeout= (the family's own
    discipline marks boundaries that way), or is one of the known
    boundary callables."""
    if has_kwarg(node, "timeout"):
        return True
    name = dotted_name(node.func) or ""
    return name in ("urllib.request.urlopen", "urlopen") or name in _SUBPROCESS


def _broad_handler(h: ast.ExceptHandler) -> bool:
    t = h.type
    if t is None:
        return True
    names = list(t.elts) if isinstance(t, ast.Tuple) else [t]
    return any(
        isinstance(n, ast.Name) and n.id in ("Exception", "BaseException")
        for n in names
    )


def _handler_accounts(h: ast.ExceptHandler) -> bool:
    """Does the handler re-raise, count a metric, or feed the
    breaker? An augmented add on an attribute (self.failures += 1)
    counts as a metric bump."""
    for n in ast.walk(h):
        if isinstance(n, ast.Raise):
            return True
        if isinstance(n, ast.Call):
            callee = (
                n.func.attr
                if isinstance(n.func, ast.Attribute)
                else (n.func.id if isinstance(n.func, ast.Name) else None)
            )
            if callee in _ACCOUNTING_CALLS:
                return True
        if (
            isinstance(n, ast.AugAssign)
            and isinstance(n.op, ast.Add)
            and isinstance(n.target, ast.Attribute)
        ):
            # an ATTRIBUTE bump (self.failures += 1) is a counter
            # someone can read; a local `attempts += 1` is loop
            # bookkeeping, not accounting
            return True
    return False


def check(ctx: Context) -> list[Violation]:
    out: list[Violation] = []
    for sf in ctx.scoped(SCOPE):
        for node in dataflow.get_index(ctx).walk(sf):
            if isinstance(node, ast.Try):
                if not any(
                    isinstance(sub, ast.Call) and _is_boundary_call(sub)
                    for stmt in node.body
                    for sub in ast.walk(stmt)
                ):
                    continue
                for h in node.handlers:
                    if _broad_handler(h) and not _handler_accounts(h):
                        out.append(
                            Violation(
                                RULE, sf.path, h.lineno,
                                "broad except swallows a boundary-call "
                                "failure without counting a metric or "
                                "feeding the breaker — the outage stays "
                                "invisible (count it, feed "
                                "record_failure, or re-raise)",
                            )
                        )
                continue
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func) or ""
            attr = (
                node.func.attr
                if isinstance(node.func, ast.Attribute)
                else None
            )
            if (
                name in ("urllib.request.urlopen", "urlopen")
                or name in _SUBPROCESS
                or attr == "communicate"
            ):
                if not has_kwarg(node, "timeout"):
                    out.append(
                        Violation(
                            RULE, sf.path, node.lineno,
                            f"`{name or attr}(...)` without timeout= — an "
                            "external call in a scheduler must bound its "
                            "wait",
                        )
                    )
            elif (
                attr == "wait"
                and not node.args
                and not node.keywords
            ):
                out.append(
                    Violation(
                        RULE, sf.path, node.lineno,
                        ".wait() with no timeout blocks a thread "
                        "unboundedly on a peer that may never signal",
                    )
                )
            elif (
                attr == "join"
                and not node.args
                and not node.keywords
            ):
                recv = dotted_name(node.func.value) or ""
                if "thread" in recv.lower():
                    out.append(
                        Violation(
                            RULE, sf.path, node.lineno,
                            f"`{recv}.join()` with no timeout — a wedged "
                            "worker thread would hang shutdown",
                        )
                    )
    return out
