"""host-transfer: implicit device-to-host syncs on tensors in the hot-path
modules.

The torch twin of the JAX package's host-transfer. `host-sync` catches
the SHAPE of a bad sync (barriers, per-element reads in loops). This
family catches the VALUE: a local bound to a tensor expression (def-use
taint over the function body — `x = torch.sum(...)`, `y = x.max(1)`,
`r = f(...)` where `f` is a project def annotated `-> torch.Tensor`,
chains hanging off any of them) that then flows into an implicit
transfer:

- `.item()`, `.tolist()`, `.cpu()`, `.numpy()`, `.to("cpu")` — each a
  blocking device round trip;
- `float(x)` / `int(x)` / `bool(x)` — calls `__float__`/`__int__`/
  `__bool__`, a hidden `.item()`;
- `np.asarray(x)` / `np.array(x)` — a full device-to-host copy;
- `if x:` / `while x:` / `assert x` / `not x` — `__bool__` on a CUDA
  tensor blocks;
- operations whose output SHAPE depends on the data: boolean-mask
  indexing (`x[x > 0]`, `x[mask]` with a mask bound to a comparison),
  `nonzero`, `torch.unique`, `masked_select`, one-argument
  `torch.where` — the host must read the count before it can allocate
  the result.

Scope is the HOT PATH only — engine.py, ops/, parallel/,
models/learned.py, host/scheduler.py, host/snapshot.py, and device.py,
which holds the read every result takes — by configuration here, not by
per-site waiver: cold modules (CLI, sim, tests plumbing) convert
freely. The ONE intended bulk read per result (`device.to_host`)
carries an inline waiver naming the contract, which is exactly the
reviewable allow-list the cycle's sync budget wants.

Besides the bindings, a value is a tensor inside the true arm of
`isinstance(x, torch.Tensor)` (the package's idiom for a leaf that may
be a tensor or host numpy); a call to a project def annotated to return
a host value (`-> bool`, `-> int`, ...) is not. Untainted receivers are
NOT flagged: if local dataflow cannot show the value is a tensor,
staying quiet beats burying real syncs in noise.
"""

from __future__ import annotations

import ast

from kubernetes_scheduler_tpu_torch.analysis.core import (
    Context,
    Violation,
    dotted_name,
)
from kubernetes_scheduler_tpu_torch.analysis import dataflow

RULE = "host-transfer"

SCOPE = (
    "kubernetes_scheduler_tpu_torch/device.py",
    "kubernetes_scheduler_tpu_torch/engine.py",
    "kubernetes_scheduler_tpu_torch/ops/*.py",
    "kubernetes_scheduler_tpu_torch/parallel/*.py",
    "kubernetes_scheduler_tpu_torch/models/learned.py",
    "kubernetes_scheduler_tpu_torch/host/scheduler.py",
    "kubernetes_scheduler_tpu_torch/host/snapshot.py",
)

_READ_METHODS = {"item", "tolist", "cpu", "numpy"}
_CONVERTERS = {"float", "int", "bool", "complex"}
_COPIERS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
# data-dependent output shapes, as tensor methods and as torch.* calls
_SHAPE_METHODS = {"nonzero", "unique", "masked_select", "argwhere",
                  "unique_consecutive"}
_SHAPE_CALLS = {f"torch.{m}" for m in _SHAPE_METHODS}
# producers of boolean tensors: a name bound to one is a mask
_MASK_CALLS = {
    "torch.isnan", "torch.isinf", "torch.isfinite", "torch.logical_and",
    "torch.logical_or", "torch.logical_not", "torch.logical_xor",
    "torch.eq", "torch.ne", "torch.lt", "torch.le", "torch.gt", "torch.ge",
}
_MASK_METHODS = {"bool", "isnan", "isinf", "isfinite", "logical_not",
                 "logical_and", "logical_or", "eq", "ne", "lt", "le", "gt",
                 "ge"}


class _Facts:
    """One function's taint facts: tensor-bound names, mask names, the
    host-returning project defs, and the names narrowed to tensors by
    `isinstance(x, torch.Tensor)` at each node of a true arm."""

    def __init__(self, fn, sources, host_fns, params):
        self.host_fns = host_fns
        self.tainted = dataflow.torch_tainted_names(
            fn, sources, host_fns, seed=params
        )
        self.narrowed: dict[int, set[str]] = {}
        for node in dataflow.shallow_walk(fn):
            if isinstance(node, (ast.If, ast.IfExp)):
                names = _isinstance_tensor(node.test)
                if not names:
                    continue
                arm = node.body if isinstance(node.body, list) else [
                    node.body
                ]
                for part in arm:
                    for sub in ast.walk(part):
                        self.narrowed.setdefault(id(sub), set()).update(names)
        self.masks = _mask_names(fn, self)

    def tensor_in(self, node: ast.AST) -> str | None:
        """The tensor a (sub)expression reads, or None. Direct torch.*
        calls count too — `float(torch.sum(x))` syncs without a
        binding. Static-metadata reads (`float(y.ndim)`,
        `int(t.size(0))`) and calls to host-returning defs are host
        values, not syncs — same exemptions the taint binder applies."""
        skip = dataflow.static_meta_node_ids(node) | (
            dataflow.host_call_node_ids(node, self.host_fns)
        )
        # the result of a read (`t.cpu()`, `t.tolist()`) is a host value:
        # the read itself is flagged where it is
        for sub in ast.walk(node):
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _READ_METHODS
            ):
                skip.update(id(inner) for inner in ast.walk(sub))
        for sub in ast.walk(node):
            if id(sub) in skip:
                continue
            if isinstance(sub, ast.Name) and sub.id in self.tainted:
                return sub.id
            if isinstance(sub, (ast.Name, ast.Attribute)):
                dn = dotted_name(sub)
                if dn and dn in self.narrowed.get(id(sub), ()):
                    return dn
            if isinstance(sub, ast.Call):
                dn = dotted_name(sub.func) or ""
                if dn.startswith("torch.") and dn not in (
                    dataflow._TORCH_HOST_RETURNS
                ):
                    return dn
        return None


def _isinstance_tensor(test: ast.AST) -> set[str]:
    """Dotted names a test proves to be tensors: `isinstance(x,
    torch.Tensor)`, alone or as a conjunct of an `and`."""
    parts = test.values if (
        isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And)
    ) else [test]
    out = set()
    for t in parts:
        if (
            isinstance(t, ast.Call)
            and isinstance(t.func, ast.Name)
            and t.func.id == "isinstance"
            and len(t.args) == 2
            and dotted_name(t.args[1]) in ("torch.Tensor", "Tensor")
            and dotted_name(t.args[0])
        ):
            out.add(dotted_name(t.args[0]))
    return out


def _mask_expr(node: ast.AST, facts: _Facts, masks: set[str]) -> bool:
    """True when `node` is a boolean tensor: a comparison on a tensor, a
    mask name, `~`/`&`/`|` of masks, or a mask-producing call."""
    if isinstance(node, ast.Name):
        return node.id in masks
    if isinstance(node, ast.Compare):
        return facts.tensor_in(node) is not None
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return _mask_expr(node.operand, facts, masks)
    if isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)
    ):
        return _mask_expr(node.left, facts, masks) or _mask_expr(
            node.right, facts, masks
        )
    if isinstance(node, ast.Call):
        dn = dotted_name(node.func) or ""
        if dn in _MASK_CALLS:
            return True
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _MASK_METHODS:
            return facts.tensor_in(fn.value) is not None
    return False


def _mask_names(fn: ast.AST, facts: _Facts) -> set[str]:
    """Names bound to a boolean tensor somewhere in `fn` (to a fixpoint,
    so `m2 = m & ok` follows `m = x > 0`)."""
    masks: set[str] = set()
    changed = True
    while changed:
        changed = False
        for node in dataflow.shallow_walk(fn):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            t = node.targets[0]
            if (
                isinstance(t, ast.Name)
                and t.id not in masks
                and _mask_expr(node.value, facts, masks)
            ):
                masks.add(t.id)
                changed = True
    return masks


def _is_cpu_move(call: ast.Call) -> bool:
    """`.to("cpu")`, `.to(device="cpu")`, `.to(torch.device("cpu"))`."""
    vals = list(call.args) + [
        kw.value for kw in call.keywords if kw.arg == "device"
    ]
    for v in vals:
        if isinstance(v, ast.Call) and dotted_name(v.func) == "torch.device":
            v = v.args[0] if v.args else v
        if isinstance(v, ast.Constant) and v.value == "cpu":
            return True
    return False


def _tensor_params(fn: ast.AST) -> set[str]:
    """Parameters annotated as tensors (keyword-only included — `def
    f(*, scores: torch.Tensor)`)."""
    return {
        a.arg
        for a in fn.args.args + fn.args.posonlyargs + fn.args.kwonlyargs
        if a.annotation is not None
        and (dotted_name(a.annotation) or "") in ("torch.Tensor", "Tensor")
    }


def check(ctx: Context) -> list[Violation]:
    out: list[Violation] = []
    index = dataflow.get_index(ctx)
    # device-returning project functions: defs annotated `-> Tensor` — a
    # call like `ops.fused.masked_score(...)` taints its binding even
    # though the def lives in another module; defs annotated to return a
    # host value never do
    sources = dataflow.tensor_returning_names(index)
    host_fns = dataflow.host_returning_names(index)
    for sf in ctx.scoped(SCOPE):
        for fi in index.functions(sf):
            facts = _Facts(
                fi.node, sources, host_fns, _tensor_params(fi.node)
            )
            # no early-out on an empty taint set: a converter applied
            # DIRECTLY to a torch call (`float(torch.mean(x))`) syncs
            # with no binding anywhere
            for node in dataflow.shallow_walk(fi.node):
                _check_node(node, facts, sf, out)
    return out


def _check_node(node, facts: _Facts, sf, out: list[Violation]) -> None:
    if isinstance(node, ast.Call):
        dn = dotted_name(node.func) or ""
        attr = (
            node.func.attr if isinstance(node.func, ast.Attribute) else None
        )
        recv = facts.tensor_in(node.func.value) if attr else None
        if attr in _READ_METHODS and recv:
            out.append(Violation(
                RULE, sf.path, node.lineno,
                f".{attr}() on tensor `{recv}` — a blocking device→host "
                "transfer on the hot path",
            ))
        elif attr == "to" and recv and _is_cpu_move(node):
            out.append(Violation(
                RULE, sf.path, node.lineno,
                f'.to("cpu") on tensor `{recv}` — a blocking device→host '
                "transfer on the hot path",
            ))
        elif dn in _CONVERTERS and node.args:
            src = facts.tensor_in(node.args[0])
            if src:
                out.append(Violation(
                    RULE, sf.path, node.lineno,
                    f"{dn}() on tensor `{src}` — implicit .item() device "
                    "sync on the hot path",
                ))
        elif dn in _COPIERS and node.args:
            src = facts.tensor_in(node.args[0])
            if src:
                out.append(Violation(
                    RULE, sf.path, node.lineno,
                    f"{dn}() on tensor `{src}` — device→host copy on the "
                    "hot path; read once in bulk at the dispatch boundary",
                ))
        elif (attr in _SHAPE_METHODS and recv) or (
            dn in _SHAPE_CALLS
        ) or (dn == "torch.where" and len(node.args) == 1):
            what = (
                f".{attr}() on tensor `{recv}`" if attr in _SHAPE_METHODS
                and recv else f"{dn}()"
            )
            out.append(Violation(
                RULE, sf.path, node.lineno,
                f"{what} — output shape depends on the data, so the host "
                "blocks to read the count; keep a fixed-shape mask "
                "(torch.where(mask, x, fill)) instead",
            ))
    elif isinstance(node, ast.Subscript) and isinstance(
        getattr(node, "ctx", None), ast.Load
    ):
        if _mask_expr(node.slice, facts, facts.masks):
            base = facts.tensor_in(node.value) or (
                dotted_name(node.value) or "value"
            )
            out.append(Violation(
                RULE, sf.path, node.lineno,
                f"boolean-mask indexing of `{base}` — output shape depends "
                "on the data, so the host blocks to read the count; keep a "
                "fixed-shape mask (torch.where(mask, x, fill)) instead",
            ))
    elif isinstance(node, (ast.If, ast.While)):
        src = _tensor_test(node.test, facts)
        if src:
            out.append(Violation(
                RULE, sf.path, node.test.lineno,
                f"branch on tensor `{src}` — __bool__ blocks on a CUDA "
                "tensor; compute the predicate on host or use torch.where",
            ))
    elif isinstance(node, ast.Assert):
        src = _tensor_test(node.test, facts)
        if src:
            out.append(Violation(
                RULE, sf.path, node.lineno,
                f"assert on tensor `{src}` — __bool__ device sync on the "
                "hot path",
            ))


def _tensor_test(test: ast.AST, facts: _Facts) -> str | None:
    """A test whose VALUE is a tensor: a tainted name, a tensor method or
    torch.* call (`t.any()`, `torch.all(m)`), a comparison with a tensor
    operand (`t.sum() > 0`), or `not`/`and`/`or` of those — each calls
    __bool__ on a tensor. Identity tests (`t is None`), host reads
    (`t.item() > 0`, flagged where the read is), calls to host-returning
    defs and shape probes (`t.shape[0] > 0`) stay quiet."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _tensor_test(test.operand, facts)
    if isinstance(test, ast.BoolOp):
        for v in test.values:
            src = _tensor_test(v, facts)
            if src:
                return src
        return None
    if isinstance(test, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
            return None
        for v in [test.left] + list(test.comparators):
            src = _tensor_test(v, facts)
            if src:
                return src
        return None
    if isinstance(test, ast.Name):
        return test.id if test.id in facts.tainted else None
    if isinstance(test, ast.Call):
        dn = dotted_name(test.func) or ""
        if dn.startswith("torch.") and dn not in dataflow._TORCH_HOST_RETURNS:
            return dn
        fn = test.func
        if (
            isinstance(fn, ast.Attribute)
            and fn.attr not in _READ_METHODS
            and fn.attr not in dataflow._STATIC_META_METHODS
        ):
            return _tensor_test(fn.value, facts)
    if isinstance(test, ast.BinOp):
        return _tensor_test(test.left, facts) or _tensor_test(
            test.right, facts
        )
    return None
