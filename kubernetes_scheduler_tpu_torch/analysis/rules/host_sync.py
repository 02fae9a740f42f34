"""host-sync: no device barriers or per-element syncs in the cycle path.

The torch twin of the JAX package's host-sync. The scheduling cycle's
contract is ONE bulk device-to-host read per dispatch (`device.to_host`
on the whole result). Flagged in the cycle-path files:

- `torch.cuda.synchronize()`, and `.synchronize()` on an event or a
  stream, anywhere — a full device barrier has no place in the serving
  path (a timing harness waives it with a justification);
- `.item()`, `.cpu()`, `.tolist()` or `.numpy()` inside a loop or
  comprehension — on a CUDA tensor each is one blocking transfer per
  element;
- `np.asarray(...)` inside a loop or comprehension — hoist one bulk
  conversion out of the loop instead.

Sites operating on host values by construction are waived inline — the
per-site triage IS the allow-list, kept next to the code it blesses.
"""

from __future__ import annotations

import ast

from kubernetes_scheduler_tpu_torch.analysis.core import (
    Context,
    Violation,
    dotted_name,
)

RULE = "host-sync"

SCOPE = (
    "kubernetes_scheduler_tpu_torch/engine.py",
    "kubernetes_scheduler_tpu_torch/host/scheduler.py",
    "kubernetes_scheduler_tpu_torch/host/queue.py",
    "kubernetes_scheduler_tpu_torch/host/observe.py",
    "kubernetes_scheduler_tpu_torch/bridge/client.py",
    "kubernetes_scheduler_tpu_torch/bridge/server.py",
    "kubernetes_scheduler_tpu_torch/parallel/engine.py",
    "kubernetes_scheduler_tpu_torch/models/learned.py",
)

_LOOPY_SYNCS = {"np.asarray", "numpy.asarray"}
_LOOPY_METHODS = {"item", "cpu", "tolist", "numpy"}


def _iter_children_with_loop(node: ast.AST, in_loop: bool):
    """(child, in_loop) pairs. A loop's per-iteration parts (body, each
    element expression) count as in-loop; its once-evaluated parts do
    not — `for x in t.tolist():` IS the recommended bulk hoist, and a
    comprehension's FIRST source iterable likewise runs exactly once."""
    if isinstance(node, (ast.For, ast.AsyncFor)):
        yield node.target, in_loop
        yield node.iter, in_loop  # evaluated once, before iteration
        for stmt in node.body + node.orelse:
            yield stmt, True
        return
    if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                         ast.GeneratorExp)):
        for i, gen in enumerate(node.generators):
            # the first generator's source is evaluated once; nested
            # generators' sources re-evaluate per outer iteration
            yield gen.iter, in_loop if i == 0 else True
            yield gen.target, True
            for cond in gen.ifs:
                yield cond, True
        if isinstance(node, ast.DictComp):
            yield node.key, True
            yield node.value, True
        else:
            yield node.elt, True
        return
    for child in ast.iter_child_nodes(node):
        yield child, in_loop or isinstance(child, ast.While)


def _visit(node: ast.AST, in_loop: bool, sf, out: list[Violation]) -> None:
    for child, child_in_loop in _iter_children_with_loop(node, in_loop):
        if isinstance(child, ast.Call):
            name = dotted_name(child.func)
            attr = (
                child.func.attr
                if isinstance(child.func, ast.Attribute)
                else None
            )
            if name == "torch.cuda.synchronize":
                out.append(
                    Violation(
                        RULE, sf.path, child.lineno,
                        "device barrier (torch.cuda.synchronize) in the "
                        "host cycle path",
                    )
                )
            elif attr == "synchronize":
                out.append(
                    Violation(
                        RULE, sf.path, child.lineno,
                        "device barrier (.synchronize() on an event or a "
                        "stream) in the host cycle path",
                    )
                )
            elif child_in_loop and attr in _LOOPY_METHODS:
                out.append(
                    Violation(
                        RULE, sf.path, child.lineno,
                        f".{attr}() inside a loop — one blocking device "
                        "transfer per element; sync once in bulk outside",
                    )
                )
            elif child_in_loop and name in _LOOPY_SYNCS:
                out.append(
                    Violation(
                        RULE, sf.path, child.lineno,
                        f"{name}() inside a loop — hoist one bulk "
                        "conversion out of the loop",
                    )
                )
        _visit(child, child_in_loop, sf, out)


def check(ctx: Context) -> list[Violation]:
    out: list[Violation] = []
    for sf in ctx.scoped(SCOPE):
        _visit(sf.tree, False, sf, out)
    return out
