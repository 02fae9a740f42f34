"""What the harness loads: never jax, flax or the JAX package (top-level
names compared whole, since the port's name begins with the JAX
package's), and the reference loads no part of the port either."""

from __future__ import annotations

import json
import subprocess
import sys

from schedbench.tests.conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "kubernetes_scheduler_tpu")

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _loaded(body: str) -> set:
    code = PROBE.format(root=str(ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_schedbench_a_run_loads_no_jax():
    body = (
        "from schedbench.tests.conftest import tiny_cell, cpu_run\n"
        "out = cpu_run(tiny_cell('basic-5k.saturated'), seconds=0.5)\n"
        "assert out['correct']\n"
    )
    top = _loaded(body)
    assert "kubernetes_scheduler_tpu_torch" in top
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_schedbench_reference_loads_no_program():
    top = _loaded("import schedbench.reference, schedbench.roofline, schedbench.gen.traffic")
    assert not top & {*FORBIDDEN, "kubernetes_scheduler_tpu_torch"}


def test_schedbench_guard_compares_whole_top_level_names():
    from schedbench import run

    sys.modules.setdefault("kubernetes_scheduler_tpu_torch_probe", sys)
    try:
        assert "kubernetes_scheduler_tpu_torch_probe" not in run.forbidden_modules()
    finally:
        del sys.modules["kubernetes_scheduler_tpu_torch_probe"]
