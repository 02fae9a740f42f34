"""The drift layer: every model transition is bound to real code.

A protocol model that nobody updates is worse than prose — it would
keep "passing" while the code moves out from under it. So each
transition in protocols.py declares one or more `Anchor`s naming the
function it abstracts, source fragments that must appear inside that
function, and call-graph edges that must exist — all verified against
the shared parse-once ModuleIndex (analysis/dataflow.py), as
contracts.py binds output specs by calling the engine. Renaming
`_invalidate_session`, moving the latch reset out of it, or dropping
the `restore_window` call from `_defer_gang` fails lint with a
`protocol-model` finding naming the transition whose model-code bond
broke.

Fragment matching is substring within the resolved def's CODE —
`ast.unparse` with docstrings dropped, so a docstring or comment that
merely mentions the fragment cannot keep a dead anchor alive (the
verify drive caught exactly that: seeding the downgrade bug back into
`_invalidate_session` left its docstring's table mention satisfying
the raw-source match). Deliberately simple beyond that: an anchor is a
tripwire, not a proof (the proof is the model + the mutation harness).
Call edges go through the real resolved call graph, so a refactor that
reroutes a transition through a helper updates the anchor or fails
loudly.
"""

from __future__ import annotations

import ast
import copy
from dataclasses import dataclass

from kubernetes_scheduler_tpu_torch.analysis.core import Violation

RULE = "protocol-model"


@dataclass(frozen=True)
class Anchor:
    """One model-transition <-> code-site bond.

    path:          repo-relative file ("kubernetes_scheduler_tpu_torch/...")
    func:          dotted def name within the file ("Cls.method" / "fn")
    must_contain:  source fragments that must occur inside the def
    calls:         bare callee names the def must reach (call graph)
    """

    path: str
    func: str
    must_contain: tuple = ()
    calls: tuple = ()


def _resolve(index, anchor: Anchor):
    """The FuncInfo for anchor.path::anchor.func, or None."""
    qname = f"{anchor.path}::{anchor.func}"
    fi = index.funcs.get(qname)
    if fi is not None:
        return fi
    # nested scopes index as Outer.inner; accept a unique suffix match
    # on the same file so anchors survive a class rename-with-alias
    tail = "." + anchor.func
    cands = [
        f for q, f in index.funcs.items()
        if q.startswith(anchor.path + "::") and q.endswith(tail)
    ]
    return cands[0] if len(cands) == 1 else None


def _def_source(fi) -> str:
    """The def's CODE: comments are gone by construction (ast), and
    docstrings are stripped before unparsing — a fragment match against
    this is a match against executable source, never prose."""
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


def verify_anchor(index, model_name: str, tname: str, anchor: Anchor) -> list:
    """Violations for one anchor against the live index."""
    out = []
    fi = _resolve(index, anchor)
    if fi is None:
        out.append(
            Violation(
                RULE, anchor.path, 1,
                f"model `{model_name}` transition `{tname}` is anchored "
                f"to `{anchor.func}`, which no longer exists in this "
                "file — update the protocol model (analysis/model/"
                "protocols.py) to match the refactor, or restore the "
                "function",
            )
        )
        return out
    src = _def_source(fi)
    line = fi.node.lineno
    for frag in anchor.must_contain:
        if frag not in src:
            out.append(
                Violation(
                    RULE, anchor.path, line,
                    f"model `{model_name}` transition `{tname}`: "
                    f"`{anchor.func}` no longer contains `{frag}` — the "
                    "code moved out from under the protocol model; "
                    "re-derive the transition (analysis/model/"
                    "protocols.py) against the new code",
                )
            )
    if anchor.calls:
        callee_names = {
            q.rsplit("::", 1)[-1].rsplit(".", 1)[-1]
            for q in index.callees(fi.qname)
        }
        for want in anchor.calls:
            if want not in callee_names and f"{want}(" not in src:
                out.append(
                    Violation(
                        RULE, anchor.path, line,
                        f"model `{model_name}` transition `{tname}`: "
                        f"`{anchor.func}` no longer calls `{want}` — "
                        "the transition's effect is modeled on that "
                        "edge; update the model or the code",
                    )
                )
    return out


def verify_model_anchors(index, model) -> list:
    out = []
    for t in model.transitions:
        for anchor in t.anchors:
            out.extend(verify_anchor(index, model.name, t.name, anchor))
    return out
