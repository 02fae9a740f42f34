"""The port's import surface: every name a package `__init__` of the JAX
package binds (its imports, classes, functions and public assignments,
read from the source, so the reference's modules are not imported)
resolves in the port's package of the same name, and utils.padding's
pad_to_bucket is bitwise the reference's.

`analysis/` is ported as far as its layer 1 (its package exports the
reference's Context, Violation and run_lint); the sharded fold factories
were folded into ShardedEngine's resident state, which the mesh tests
hold against the reference's."""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest

from kubernetes_scheduler_tpu.utils import padding as ref_padding
from kubernetes_scheduler_tpu_torch.utils import pad_to_bucket

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ["", "host", "ops", "utils", "models", "parallel", "bridge", "kube", "sim",
            "sim.scenarios", "trace", "native", "analysis"]
FOLDED = {"make_sharded_apply_delta_fn", "make_sharded_build_layout_fn",
          "make_sharded_apply_layout_fn"}


def reference_exports(package: str) -> set:
    path = ROOT / "kubernetes_scheduler_tpu" / package.replace(".", "/") / "__init__.py"
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_") or n == "__version__"}


@pytest.mark.parametrize("package", PACKAGES, ids=[p or "top" for p in PACKAGES])
def test_torch_package_exports_match_reference(package):
    want = reference_exports(package)
    assert want, package
    module = importlib.import_module(
        "kubernetes_scheduler_tpu_torch" + (f".{package}" if package else ""))
    missing = sorted(n for n in want - FOLDED if not hasattr(module, n))
    assert not missing, (package, missing)
    if package == "parallel":
        assert want & FOLDED == FOLDED
    if package in ("host", "ops", "utils", "models"):
        # the lazily resolved names are listed, and are the port's own
        assert want <= set(module.__all__)
        for name in want:
            value = getattr(module, name)
            home = getattr(value, "__module__", None) or getattr(value, "__name__", None)
            assert home is None or home.startswith("kubernetes_scheduler_tpu_torch."), name


def test_torch_package_version_and_unknown_names():
    import kubernetes_scheduler_tpu
    import kubernetes_scheduler_tpu_torch as port
    from kubernetes_scheduler_tpu_torch import host, ops

    assert port.__version__ == kubernetes_scheduler_tpu.__version__
    assert ops.resources is importlib.import_module("kubernetes_scheduler_tpu_torch.ops.resources")
    for module in (port, host, ops):
        with pytest.raises(AttributeError):
            module.no_such_name  # noqa: B018


PAD_CASES = {
    "vector": (np.arange(5, dtype=np.float32), 0, {}),
    "bucket-edge": (np.arange(16, dtype=np.int32), 0, {}),
    "rows": (np.arange(30, dtype=np.float32).reshape(10, 3), 0, dict(fill=-1)),
    "columns": (np.arange(30, dtype=np.float32).reshape(3, 10), 1, dict(floor=4)),
    "bool": (np.ones(9, bool), 0, dict(fill=False)),
    "empty": (np.zeros((0, 2), np.float32), 0, {}),
}


@pytest.mark.parametrize("case", list(PAD_CASES))
def test_torch_pad_to_bucket_matches_reference(case):
    arr, axis, kw = PAD_CASES[case]
    got, got_mask = pad_to_bucket(arr, axis, **kw)
    want, want_mask = ref_padding.pad_to_bucket(arr, axis, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got_mask.dtype == want_mask.dtype == np.bool_
