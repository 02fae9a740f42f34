"""dtype-shape: no float64 in the engine.

The torch twin of the float64 half of the JAX package's dtype-shape.
The engine is a float32 machine end to end (the codec's allowed dtypes,
the CUDA kernels' float pointers, the wire contract): one float64
tensor silently doubles transfer volume, runs the card's float64 units
at a fraction of the float32 rate, and gives scores that differ from the
kernels' and the reference's. Flagged in engine.py, ops/, parallel/ and
models/:

- `torch.float64` / `torch.double` anywhere (a dtype argument, a `.to`
  target, a comparison);
- `.double()`;
- dtype arguments and astype targets that resolve to float64 (`float`,
  `np.float64`, `"float64"`, `"double"`).

The traced-bool half of the JAX family has no twin here: in eager torch
a Python branch on a tensor is a device sync, which host-transfer
flags.
"""

from __future__ import annotations

import ast

from kubernetes_scheduler_tpu_torch.analysis import dataflow
from kubernetes_scheduler_tpu_torch.analysis.core import (
    Context,
    Violation,
    dotted_name,
)

RULE = "dtype-shape"

SCOPE = (
    "kubernetes_scheduler_tpu_torch/engine.py",
    "kubernetes_scheduler_tpu_torch/ops/*.py",
    "kubernetes_scheduler_tpu_torch/parallel/*.py",
    "kubernetes_scheduler_tpu_torch/models/*.py",
)

_TORCH_F64 = {"torch.float64", "torch.double"}
_F64_NAMES = _TORCH_F64 | {
    "float", "np.float64", "numpy.float64", "np.double", "numpy.double",
}
_F64_STRINGS = {"float64", "double", "f8", "<f8"}


def _is_f64(node: ast.AST) -> bool:
    name = dotted_name(node)
    if name in _F64_NAMES:
        return True
    return (
        isinstance(node, ast.Constant)
        and isinstance(node.value, str)
        and node.value in _F64_STRINGS
    )


_MSG = "(the engine is float32 end to end)"


def _check_f64(ctx, sf, out: list[Violation]) -> None:
    # a torch.float64 inside a flagged dtype= / astype argument is one
    # finding, not two
    reported: set[int] = set()
    nodes = dataflow.get_index(ctx).walk(sf)
    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        attr = fn.attr if isinstance(fn, ast.Attribute) else None
        if attr == "double" and not node.args:
            out.append(Violation(
                RULE, sf.path, node.lineno,
                f".double() in engine code {_MSG}",
            ))
        elif attr == "astype" and node.args and _is_f64(node.args[0]):
            reported.add(id(node.args[0]))
            out.append(Violation(
                RULE, sf.path, node.lineno,
                f"astype to float64 in engine code {_MSG}",
            ))
        for kw in node.keywords:
            if kw.arg == "dtype" and _is_f64(kw.value):
                reported.add(id(kw.value))
                out.append(Violation(
                    RULE, sf.path, kw.value.lineno,
                    f"float64 dtype argument in engine code {_MSG}",
                ))
    for node in nodes:
        if (
            isinstance(node, ast.Attribute)
            and id(node) not in reported
            and dotted_name(node) in _TORCH_F64
        ):
            out.append(Violation(
                RULE, sf.path, node.lineno,
                f"{dotted_name(node)} in engine code {_MSG}",
            ))


def check(ctx: Context) -> list[Violation]:
    out: list[Violation] = []
    for sf in ctx.scoped(SCOPE):
        _check_f64(ctx, sf, out)
    return out
