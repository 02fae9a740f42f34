"""sim-determinism: every random draw in sim/ flows from an explicit
seed.

The simulators are not decoration — scenario journals are REPLAY-PINNED
(`trace replay` diffs bindings bitwise) and double as the learned-policy
training-data generator, so a scenario run must be a pure function of
(name, seed, scale). One module-level `np.random.random()` or stdlib
`random.choice()` breaks that silently: the run still "works", the
journal still replays, but the same seed no longer reproduces the same
traffic and every cross-run comparison (bench deltas, parity suites,
regression bisects) quietly measures noise. Flagged in sim/ files:

- `np.random.*` / `numpy.random.*` calls — the GLOBAL numpy RNG
  (process-wide state, import-order dependent). Includes
  `np.random.seed(...)`: seeding the global RNG still leaves every
  other module sharing the stream.
- unseeded `default_rng()` / `np.random.default_rng()` — a fresh OS-
  entropy generator per call; `default_rng(seed)` is the clean form.
- stdlib `random.*` calls — the other global RNG.

Clean: `default_rng(seed)` and anything drawn from a generator object
(`rng.integers(...)`, `rng.choice(...)`), which is how every shipped
simulator threads its seed.
"""

from __future__ import annotations

import ast

from kubernetes_scheduler_tpu_torch.analysis import dataflow
from kubernetes_scheduler_tpu_torch.analysis.core import (
    Context,
    Violation,
    dotted_name,
)

RULE = "sim-determinism"

SCOPE = (
    "kubernetes_scheduler_tpu_torch/sim/*.py",
    "kubernetes_scheduler_tpu_torch/sim/**/*.py",
)

# stdlib `random` module functions (dotted root `random.`); a bare
# attribute probe is not a draw, only calls are flagged
_STDLIB_ROOT = "random."


def _is_default_rng(name: str) -> bool:
    return name == "default_rng" or name.endswith(".default_rng")


def check(ctx: Context) -> list[Violation]:
    out: list[Violation] = []
    for sf in ctx.scoped(SCOPE):
        for node in dataflow.get_index(ctx).walk(sf):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name is None:
                continue
            if _is_default_rng(name):
                if not node.args and not node.keywords:
                    out.append(Violation(
                        RULE, sf.path, node.lineno,
                        "unseeded default_rng(): a fresh OS-entropy "
                        "generator per call — pass the scenario/config "
                        "seed (default_rng(seed)) so runs reproduce",
                    ))
                continue
            if name.startswith(("np.random.", "numpy.random.")):
                out.append(Violation(
                    RULE, sf.path, node.lineno,
                    f"`{name}` draws from numpy's GLOBAL RNG "
                    "(process-wide, import-order dependent) — create a "
                    "generator with default_rng(seed) and draw from it",
                ))
                continue
            if name.startswith(_STDLIB_ROOT) and name.count(".") == 1:
                out.append(Violation(
                    RULE, sf.path, node.lineno,
                    f"`{name}` draws from the stdlib GLOBAL RNG — "
                    "create a generator with default_rng(seed) and "
                    "draw from it",
                ))
    return out
