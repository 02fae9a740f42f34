"""Layer 2: engine contracts, checked by calling the entry points.

The counterpart of kubernetes_scheduler_tpu/analysis/contracts.py. The
reference proves the engine boundary's shape/dtype contract with
jax.eval_shape; PyTorch has no abstract evaluation of a program that
reads host values (the auction's any-bid read, K4's fallback count), so
here each entry point is CALLED on zero-filled inputs on the device asked
for, and its output's shapes and dtypes are diffed leaf for leaf against
a declared spec: a tuple (shape, torch.dtype) per leaf, built from the
grid point. On the card that runs K1-K4 themselves; on the CPU (the
tests, `--device cpu`) their plain versions.

Every entry point the host and the bridge dispatch to is declared with
its expected output spec, across the bucket-shape GRID:

- `engine.schedule_batch` (greedy, and the auction at auction_rounds=4)
  — ScheduleResult;
- the fused drift check: `schedule_batch(fused=True)` must give exactly
  the spec of the unfused call it replaces;
- `engine.schedule_windows` — WindowsResult;
- `engine.apply_snapshot_delta` / `engine.apply_layout_delta` — in-place
  folds, spec-preserving leaf for leaf;
- `engine.build_fused_layout` — the port's layout formula: row-major
  [n] / [n, r], no tile padding;
- the four kernel wrappers of ops/fused.py (`fused_masked_score`,
  `fused_score_row_stats`, `auction_bid`, `greedy_scan`).

The schedule surfaces run with affinity_aware=False (the host's fused
production options), so the greedy scan is K4 and the auction's bid
head K3; the output spec does not depend on it.

The mesh-sharded surfaces (parallel/engine.py's factories and
ShardedEngine's resident path, plus the sharded schedule under each
option whose collective sites the defaults never reach: a constraints
window through either assigner, every other policy, softmax, the soft
term, a plugin list) run on a 4-shard mesh and a 2 x 2
(dcn, node) mesh of one device: the sharded spec must equal the dense
spec leaf for leaf (per-shard results joined along the node axis), the
divisibility formula n % mesh.size == 0 must predict success AND failure
(parallel/engine.py's ValueError), and the collective budget must hold.

The budget is the twin of the reference's static collective count: the
number of distinct CALL SITES of each collective kind (parallel/mesh.py's
psum, pmax, pmin, all_gather, gather_cat, broadcast, to_lead,
reduce_lead) that one run of a surface reaches, seen through
mesh.set_observer. A site inside the per-pod election loop counts once,
as a scan body does in a jaxpr, yet an extra collective there still
moves the count; counts of calls would follow the number of pods and
rounds and could not be pinned. Sites do not depend on the device, so
the file written on the CPU holds on the card. Regenerate it after an
intentional change with
`python -m kubernetes_scheduler_tpu_torch.analysis --write-collective-budget --device cpu`.

Findings are pseudo-rules `engine-contract` and `collective-budget`.
`device=None` means cuda, as every entry point of the port: without a
card the layer raises RuntimeError and never falls back to the CPU.
Fixture modules declare contracts in miniature (a CONTRACTS table,
check_fixture_module), evaluated on torch.device("meta"): no compute,
no allocation.
"""

from __future__ import annotations

import os

from kubernetes_scheduler_tpu_torch.analysis.core import _REPO_ROOT, Violation

RULE = "engine-contract"

# bucket-shape grid: (nodes, pods, resources, selectors, windows)
GRID = (
    dict(n=16, p=8, r=7, s=3, w=2),
    dict(n=64, p=32, r=7, s=3, w=2),
)
# the main path's width (the gpu-10kx10k config, chip_smoke.py's phases)
FULL = dict(n=10_000, p=1_024, r=3, s=1, w=8)

ENGINE_PATH = "kubernetes_scheduler_tpu_torch/engine.py"
FUSED_PATH = "kubernetes_scheduler_tpu_torch/ops/fused.py"
PARALLEL_PATH = "kubernetes_scheduler_tpu_torch/parallel/engine.py"

# the files whose edits can move a declared contract or the budget — a
# changed-only lint run checks the layer only when its closure touches these
SURFACE = (
    ENGINE_PATH,
    "kubernetes_scheduler_tpu_torch/ops/*.py",
    "kubernetes_scheduler_tpu_torch/parallel/*.py",
    "kubernetes_scheduler_tpu_torch/analysis/contracts.py",
    "kubernetes_scheduler_tpu_torch/analysis/spmd.py",
    "kubernetes_scheduler_tpu_torch/analysis/spmd_mutants.py",
    # the sharded delta router lives host-side
    "kubernetes_scheduler_tpu_torch/host/snapshot.py",
)

# the entry points checked — tests assert coverage
CONTRACT_NAMES = (
    "schedule_batch", "schedule_batch(auction)", "schedule_batch(fused)",
    "schedule_windows", "apply_snapshot_delta", "apply_layout_delta",
    "build_fused_layout", "fused_masked_score", "fused_score_row_stats",
    "auction_bid", "greedy_scan",
)


# ---- specs -----------------------------------------------------------------


def _is_leaf(x) -> bool:
    """A declared leaf: (shape tuple, torch.dtype)."""
    return (
        isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)
        and not hasattr(x, "_fields")
        and (x[1] is None or type(x[1]).__name__ == "dtype")
    )


def spec_of(tree):
    """Tensors -> (shape, dtype) leaves, NamedTuples and tuples kept."""
    import torch

    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if hasattr(tree, "_fields"):
        return type(tree)(*[spec_of(x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return tuple(spec_of(x) for x in tree)
    return tree


def _flatten(tree, prefix=""):
    """[(path, leaf)] and a structure signature."""
    if _is_leaf(tree) or not isinstance(tree, tuple):
        return [(prefix, tree)], "*"
    names = getattr(tree, "_fields", None) or [str(i) for i in range(len(tree))]
    leaves, sig = [], []
    for name, x in zip(names, tree):
        sub, s = _flatten(x, f"{prefix}.{name}" if prefix else name)
        leaves.extend(sub)
        sig.append(s)
    return leaves, f"{type(tree).__name__}({', '.join(sig)})"


def _fmt(leaf) -> str:
    if not _is_leaf(leaf):
        return repr(leaf)
    shape, dtype = leaf
    return f"{shape}/{str(dtype).replace('torch.', '')}"


def leaf_mismatches(name: str, got, want) -> list[str]:
    """Human-readable diffs between two spec trees, field names attached."""
    got_leaves, got_sig = _flatten(got)
    want_leaves, want_sig = _flatten(want)
    if got_sig != want_sig:
        return [f"{name}: structure {got_sig} != declared {want_sig}"]
    out = []
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        if a != b:
            where = f"{name}.{path}" if path else name
            out.append(f"{where}: returned {_fmt(a)} != declared {_fmt(b)}")
    return out


def joined_spec(parts):
    """The spec of per-shard results joined along the node axis (dim 0 of
    every leaf), as gather_cat would join them, read from the shards'
    specs alone: no copy, no collective. A leaf whose shards disagree in
    dtype or trailing shape keeps the first shard's trailing shape with
    the dtype None, so the diff names it."""
    specs = [spec_of(p) for p in parts]
    first = specs[0]
    if _is_leaf(first):
        shapes = [s[0] for s in specs]
        same = all(s[1] == first[1] and s[0][1:] == first[0][1:] for s in specs)
        return ((sum(s[0] for s in shapes),) + first[0][1:], first[1] if same else None)
    return type(first)(*[joined_spec([s[i] for s in specs]) for i in range(len(first))])


def schedule_spec(g):
    import torch

    from kubernetes_scheduler_tpu_torch import engine

    n, p, r = g["n"], g["p"], g["r"]
    f32 = torch.float32
    return engine.ScheduleResult(
        node_idx=((p,), torch.int32), scores=((p, n), f32), raw_scores=((p, n), f32),
        feasible=((p, n), torch.bool), free_after=((n, r), f32),
        n_assigned=((), torch.int32),
    )


def windows_spec(g):
    import torch

    from kubernetes_scheduler_tpu_torch import engine

    return engine.WindowsResult(
        node_idx=((g["w"], g["p"]), torch.int32),
        free_after=((g["n"], g["r"]), torch.float32),
        n_assigned=((), torch.int32),
    )


def layout_spec(g):
    """The port's FusedLayout formula: row-major, no tile padding."""
    import torch

    from kubernetes_scheduler_tpu_torch import engine

    n, r = g["n"], g["r"]
    return engine.FusedLayout(
        u=((n,), torch.float32), v=((n,), torch.float32), node_mask=((n,), torch.bool),
        alloc=((n, r), torch.float32), reqd=((n, r), torch.float32),
    )


# ---- inputs ------------------------------------------------------------------


def make_inputs(g, device, *, constraints: bool = False):
    """Zero-filled snapshot, pods, stacked windows and delta for one grid
    point, built through the SAME constructors the host uses, on `device`.
    The delta carries one real row of each family (row 0) beside a
    sentinel, so the folds write. constraints=True gives every pod a
    required anti-affinity to selector 0, which it matches itself, and a
    topology spread of max skew 1 over the last selector (every node its
    own domain): the assigners then hold live counts, the paths a
    constraints window takes."""
    import numpy as np

    from kubernetes_scheduler_tpu_torch import engine

    n, p, r, s, w = g["n"], g["p"], g["r"], g["s"], g["w"]
    snap = engine.make_snapshot(
        np.ones((n, r), np.float32),
        np.zeros((n, r), np.float32),
        np.zeros(n, np.float32),
        np.zeros(n, np.float32),
        np.zeros(n, np.float32),
        domain_counts=np.zeros((n, s), np.float32),
        device=device,
    )

    def pods_of(k):
        matches = np.zeros((k, s), bool)
        matches[:, 0] = constraints
        kw = {}
        if constraints:
            kw = dict(
                anti_affinity_sel=np.zeros((k, 1), np.int32),
                spread_sel=np.full((k, 1), s - 1, np.int32),
                spread_max=np.ones((k, 1), np.int32),
            )
        return engine.make_pod_batch(
            np.zeros((k, r), np.float32), pod_matches=matches, device=device,
            **kw,
        )

    rows = np.array([0, n], np.int32)
    delta = engine.SnapshotDelta(
        req_rows=rows, req_vals=np.zeros((2, r), np.float32),
        util_rows=rows, util_vals=np.zeros((2, 5), np.float32),
        dom_rows=rows, dom_vals=np.zeros((2, s, 4), np.float32),
        node_mask=np.ones(n, bool),
    )
    return snap, pods_of(p), engine.stack_windows(pods_of(w * p), p), delta


def _tag(g) -> str:
    return f"[n={g['n']} p={g['p']} r={g['r']} s={g['s']}]"


# ---- the dense contracts -------------------------------------------------------


def check_contracts(device=None, grid=GRID, checked: list | None = None) -> list[Violation]:
    """Call every declared entry point on `device` (default cuda,
    RuntimeError without it) at every grid point and diff its output spec
    against the declaration. Returns [] when the engine honors its
    contracts; `checked` receives (name, grid point) of each call made."""
    import torch

    from kubernetes_scheduler_tpu_torch import engine
    from kubernetes_scheduler_tpu_torch.device import resolve_device
    from kubernetes_scheduler_tpu_torch.ops import fused

    dev = resolve_device(device)
    out: list[Violation] = []
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    for g in grid:
        n, p, r = g["n"], g["p"], g["r"]
        snap, pods, pods_w, delta = make_inputs(g, dev)
        tag = _tag(g)

        def expect(name, path, fn, args, want, *, kw=None):
            try:
                got = spec_of(fn(*args, **(kw or {})))
            except Exception as e:  # noqa: BLE001 — the call failing IS the finding
                out.append(Violation(RULE, path, 1, f"{name} {tag}: call failed: {e}"))
                return None
            if checked is not None:
                checked.append((name, dict(g)))
            for msg in leaf_mismatches(name, got, want):
                out.append(Violation(RULE, path, 1, f"{tag} {msg}"))
            return got

        sched_want = schedule_spec(g)
        kernel_path = dict(affinity_aware=False)
        unfused = expect("schedule_batch", ENGINE_PATH, engine.schedule_batch,
                         (snap, pods), sched_want, kw=dict(kernel_path, assigner="greedy"))
        expect("schedule_batch(auction)", ENGINE_PATH, engine.schedule_batch,
               (snap, pods), sched_want,
               kw=dict(kernel_path, assigner="auction", auction_rounds=4))
        # fused-vs-unfused drift: the kernel path must present the EXACT
        # spec of the path it replaces
        if unfused is not None:
            expect("schedule_batch(fused)", ENGINE_PATH, engine.schedule_batch,
                   (snap, pods), unfused, kw=dict(kernel_path, assigner="greedy", fused=True))
        expect("schedule_windows", ENGINE_PATH, engine.schedule_windows,
               (snap, pods_w), windows_spec(g), kw=kernel_path)
        lay_want = layout_spec(g)
        layout = expect("build_fused_layout", ENGINE_PATH, engine.build_fused_layout,
                        (snap,), lay_want)
        # in-place folds are spec-preserving leaf for leaf
        expect("apply_snapshot_delta", ENGINE_PATH, engine.apply_snapshot_delta,
               (snap, delta), spec_of(snap))
        if layout is not None:
            expect("apply_layout_delta", ENGINE_PATH, engine.apply_layout_delta,
                   (engine.build_fused_layout(snap), delta), lay_want)

        def z(*shape, dtype=f32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def ones(*shape):
            return torch.ones(shape, dtype=b8, device=dev)

        expect("fused_masked_score", FUSED_PATH, fused.fused_masked_score,
               (z(n), z(n), ones(n), z(n, r), z(n, r), z(p), z(p), z(p, r), ones(p)),
               ((p, n), f32))
        expect("fused_score_row_stats", FUSED_PATH, fused.fused_score_row_stats,
               (z(p), z(p), z(n), z(n), ones(n)), ((2, p), f32))
        expect("auction_bid", FUSED_PATH, fused.auction_bid,
               (z(p, n), z(n), ones(p), z(p, r), z(n, r)), (((p,), i32), ((p,), b8)))
        expect("greedy_scan", FUSED_PATH, fused.greedy_scan,
               (z(p, n), z(p, r), z(n, r)), (((p,), i32), ((n, r), f32)))
    return out


# ---- the sharded contracts and the collective budget ---------------------------

BUDGET_RULE = "collective-budget"
COLLECTIVE_BUDGET_NAME = "kubernetes_scheduler_tpu_torch/analysis/COLLECTIVE_BUDGET.json"
# the collective kinds budgeted per surface (parallel/mesh.py), in report order
COLLECTIVE_KINDS = (
    "psum", "pmax", "pmin", "all_gather", "gather_cat", "broadcast", "to_lead",
    "reduce_lead",
)
REGENERATE = (
    "python -m kubernetes_scheduler_tpu_torch.analysis --write-collective-budget "
    "--device cpu"
)

# the sharded entry points checked — tests assert coverage
SHARDED_CONTRACT_NAMES = (
    "sharded_schedule(greedy)", "sharded_schedule(auction)",
    "sharded_windows(greedy)", "sharded_windows(auction)",
    # ShardedEngine's resident path: K1 per shard on retained per-shard
    # layouts, and the per-shard in-place folds and layout build
    "sharded_schedule(fused)",
    "sharded_apply_delta",
    "sharded_build_layout",
    "sharded_apply_layout_delta",
)
# the sharded schedule under the options whose collective sites the
# default options never reach: name -> (factory options, constraints
# inputs). The live-count blocks of both assigners (a window with
# anti-affinity and spread), each policy's own bounds, softmax's gather,
# the soft term's pmin and the weighted plugin sum. Their spec is the
# default's, so they run at the grid's bucket shapes only, not at a
# full-width point (each is a per-pod loop there)
SHARDED_VARIANTS = {
    "sharded_schedule(greedy, constraints)": (dict(assigner="greedy"), True),
    "sharded_schedule(auction, constraints)": (dict(assigner="auction"), True),
    **{
        f"sharded_schedule({policy})": (dict(policy=policy), False)
        for policy in ("balanced_diskio", "free_capacity", "card", "least_allocated",
                       "balanced_allocation", "image_locality")
    },
    "sharded_schedule(softmax)": (dict(normalizer="softmax"), False),
    "sharded_schedule(soft)": (dict(soft=True), False),
    "sharded_schedule(plugins)": (
        dict(score_plugins=(("balanced_cpu_diskio", 1.0), ("least_allocated", 2.0))), False),
}
SHARDED_CONTRACT_NAMES += tuple(SHARDED_VARIANTS)


def node_axis_divisor(mesh) -> int:
    """The declared node-axis divisibility formula: every sharded surface
    requires n % mesh.size == 0 (the host pads node buckets to it).
    Checked by predicting both success and failure."""
    return int(mesh.size)


def meshes(device) -> dict:
    """name -> mesh: the manifest's 4-shard mesh (--mesh-devices 4) and a
    2 x 2 (dcn, node) mesh of a slice spanning hosts, all on `device`."""
    from kubernetes_scheduler_tpu_torch.parallel.mesh import make_mesh, make_mesh_multihost

    return {
        "mesh4": make_mesh(4, device=device),
        "mesh2x2": make_mesh_multihost(2, 2, device=device),
    }


def sharded_cases(mesh, g, device, *, variants: bool = True) -> dict:
    """name -> (prepare, declared spec) of every sharded surface at grid
    point g, the SHARDED_VARIANTS included unless variants=False.
    prepare() does the surface's set-up (the resident engine's first
    upload) and returns run(), which runs the surface alone and returns
    the spec of its result, per-shard results joined along the node axis.
    Built through the same factories and ShardedEngine the host
    dispatches through, at their default knobs."""
    from kubernetes_scheduler_tpu_torch.parallel.engine import (
        ShardedEngine,
        make_sharded_schedule_fn,
        make_sharded_windows_fn,
    )

    axes = mesh.axis_names
    snap, pods, pods_w, delta = make_inputs(g, device)

    def program(make, args, **kw):
        def prepare():
            fn = make(mesh, node_axes=axes, **kw)
            return lambda: spec_of(fn(*args))
        return prepare

    def engine(*, layouts=False):
        eng = ShardedEngine(mesh, node_axes=axes)
        eng.upload_resident(snap, layouts=layouts)
        return eng

    def fused_step():
        fn = make_sharded_schedule_fn(mesh, node_axes=axes, assigner="auction",
                                      normalizer="none", fused=True, resident_layout=True)
        shards, layouts = engine(layouts=True).upload_resident(snap, layouts=True)
        return lambda: spec_of(fn(shards, pods, layouts))

    def fold(part: int, layouts: bool):
        def prepare():
            eng = engine(layouts=layouts)

            def run():
                got = eng.upload_resident(snap, delta=delta, epoch=1, layouts=layouts)
                if not eng.resident_used_delta:
                    raise RuntimeError("the delta was not folded (a full upload ran)")
                return joined_spec(got[part])
            return run
        return prepare

    def build_layout():
        eng = ShardedEngine(mesh, node_axes=axes)
        return lambda: joined_spec(eng.upload_resident(snap, layouts=True)[1])

    cases = {}
    for assigner in ("greedy", "auction"):
        cases[f"sharded_schedule({assigner})"] = (
            program(make_sharded_schedule_fn, (snap, pods), assigner=assigner),
            schedule_spec(g))
        cases[f"sharded_windows({assigner})"] = (
            program(make_sharded_windows_fn, (snap, pods_w), assigner=assigner),
            windows_spec(g))
    cases["sharded_schedule(fused)"] = (fused_step, schedule_spec(g))
    cases["sharded_apply_delta"] = (fold(0, False), spec_of(snap))
    cases["sharded_build_layout"] = (build_layout, layout_spec(g))
    cases["sharded_apply_layout_delta"] = (fold(1, True), layout_spec(g))
    if variants:
        constrained = make_inputs(g, device, constraints=True)
        for name, (kw, constraints) in SHARDED_VARIANTS.items():
            args = constrained[:2] if constraints else (snap, pods)
            cases[name] = (program(make_sharded_schedule_fn, args, **kw), schedule_spec(g))
    return cases


class _SiteCounter:
    """The collective observer: distinct (kind, file, line) call sites."""

    def __init__(self):
        self.sites: set = set()

    def __call__(self, kind, filename, lineno):
        self.sites.add((kind, os.path.relpath(filename, _REPO_ROOT), lineno))

    def counts(self) -> dict:
        out = dict.fromkeys(COLLECTIVE_KINDS, 0)
        for kind, _, _ in self.sites:
            out[kind] += 1
        return out


def site_counts(call) -> tuple:
    """(result of call(), {kind: distinct call sites reached})."""
    from kubernetes_scheduler_tpu_torch.parallel import mesh as mesh_mod

    counter = _SiteCounter()
    previous = mesh_mod.set_observer(counter)
    try:
        result = call()
    finally:
        mesh_mod.set_observer(previous)
    return result, counter.counts()


def traced_surface_counts(device=None, mesh=None) -> dict:
    """name -> collective call-site counts of every sharded surface at
    GRID[0] on `mesh` (default the 4-shard mesh on `device`, default
    cuda): what --write-collective-budget writes and the gate compares."""
    from kubernetes_scheduler_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    mesh = mesh if mesh is not None else meshes(dev)["mesh4"]
    return {
        name: site_counts(prepare())[1]
        for name, (prepare, _) in sharded_cases(mesh, GRID[0], dev).items()
    }


def write_collective_budget(path: str | None = None, device=None) -> dict:
    """Regenerate the budget file from one run of every surface; returns
    the document."""
    import json

    doc = {
        "comment": (
            "Distinct call sites of each parallel/mesh.py collective that one "
            "run of every sharded engine surface reaches (analysis/contracts.py). "
            "Lint re-runs the surfaces and diffs; regenerate with `"
            + REGENERATE + "` after an INTENTIONAL change of the collective "
            "structure."
        ),
        "mesh_devices": 4,
        "surfaces": traced_surface_counts(device),
    }
    path = path or os.path.join(_REPO_ROOT, COLLECTIVE_BUDGET_NAME)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return doc


def check_collective_budget(
    budget_path: str | None = None, *, traced: dict, failed: set | None = None,
) -> list[Violation]:
    """Diff the per-surface collective site counts `traced` (name ->
    counts, as traced_surface_counts gives them) against the checked-in
    budget. Every failure mode is loud: a missing or unparseable budget
    file, a surface the file does not budget, a stale budgeted surface
    nothing runs anymore, and any per-kind count drift (the
    extra-collective class). `failed` names surfaces whose run failed:
    their entries are exempt from the staleness check — the failure is
    its own finding, and regenerating there would drop the pin instead of
    fixing the surface."""
    import json

    path = budget_path or os.path.join(_REPO_ROOT, COLLECTIVE_BUDGET_NAME)
    rel = COLLECTIVE_BUDGET_NAME if budget_path is None else os.path.basename(path)
    if not os.path.exists(path):
        return [Violation(
            BUDGET_RULE, rel, 1,
            f"{rel} is missing — the sharded engine's collective budget is "
            f"unpinned; run `{REGENERATE}`",
        )]
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        budget = doc["surfaces"]
        if not isinstance(budget, dict) or not all(
            isinstance(v, dict) for v in budget.values()
        ):
            raise TypeError("'surfaces' must map names to count dicts")
    except Exception as e:  # noqa: BLE001
        return [Violation(
            BUDGET_RULE, rel, 1,
            f"{rel} does not parse as {{'surfaces': {{...}}}}: {e} — "
            f"regenerate with `{REGENERATE}`",
        )]
    out: list[Violation] = []
    for name, counts in sorted(traced.items()):
        want = budget.get(name)
        if want is None:
            out.append(Violation(
                BUDGET_RULE, rel, 1,
                f"sharded surface `{name}` has no budget entry — new surfaces "
                f"must be consciously budgeted; run `{REGENERATE}`",
            ))
            continue
        diffs = [
            f"{kind}: reached {counts.get(kind, 0)} != budgeted {want.get(kind, 0)}"
            for kind in COLLECTIVE_KINDS
            if counts.get(kind, 0) != want.get(kind, 0)
        ]
        if diffs:
            out.append(Violation(
                BUDGET_RULE, PARALLEL_PATH, 1,
                f"`{name}` collective budget drift ({'; '.join(diffs)}) — an "
                "unbudgeted collective is a per-round latency tax on the "
                "election loop; fix the program, or regenerate with "
                f"`{REGENERATE}` if the change is intentional",
            ))
    for name in sorted(set(budget) - set(traced) - (failed or set())):
        out.append(Violation(
            BUDGET_RULE, rel, 1,
            f"budget entry `{name}` matches no declared sharded surface — "
            f"stale; run `{REGENERATE}`",
        ))
    return out


def check_sharded_contracts(device=None, grid=GRID, checked: list | None = None) -> list[Violation]:
    """Run every sharded surface on the 4-shard and the 2 x 2 mesh of
    `device` (default cuda, RuntimeError without it) at every grid point
    and pin (a) sharded output spec == dense spec leaf for leaf, (b) the
    divisibility formula predicting success and failure, (c) the
    collective budget, read at GRID[0] on each mesh. Returns [] when the
    mesh-sharded engine honors its contracts; `checked` receives (mesh,
    name, grid point) of each surface run."""
    from kubernetes_scheduler_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    out: list[Violation] = []
    for mesh_name, mesh in meshes(dev).items():
        divisor = node_axis_divisor(mesh)
        traced: dict = {}
        failed: set = set()
        # the budget is read at GRID[0], checked there or not
        points = [(g, g in grid, g == GRID[0]) for g in grid]
        if GRID[0] not in grid:
            points.append((GRID[0], False, True))
        for g, check_spec, count in points:
            tag = f"[{mesh_name} n={g['n']} p={g['p']} D={divisor}]"
            if g["n"] % divisor:
                out.append(Violation(
                    RULE, PARALLEL_PATH, 1,
                    f"grid point n={g['n']} violates the declared divisibility "
                    f"formula n % {divisor} == 0 — the sharded layer cannot be "
                    "checked at it",
                ))
                continue
            for name, (prepare, want) in sharded_cases(
                    mesh, g, dev, variants=g in GRID).items():
                try:
                    got, counts = site_counts(prepare())
                except Exception as e:  # noqa: BLE001 — the call failing IS the finding
                    out.append(Violation(RULE, PARALLEL_PATH, 1, f"{name} {tag}: call failed: {e}"))
                    if count:
                        failed.add(name)
                    continue
                if count:
                    traced[name] = counts
                if not check_spec:
                    continue
                if checked is not None:
                    checked.append((mesh_name, name, dict(g)))
                for msg in leaf_mismatches(name, got, want):
                    out.append(Violation(
                        RULE, PARALLEL_PATH, 1,
                        f"{tag} sharded/dense drift: {msg.replace('declared', 'dense')}",
                    ))
        # the formula must also predict FAILURE: a node count it rejects
        # must make the surface raise parallel/engine.py's ValueError
        if divisor > 1:
            g = dict(GRID[0], n=GRID[0]["n"] + 2)
            prepare = sharded_cases(mesh, g, dev, variants=False)["sharded_schedule(greedy)"][0]
            try:
                prepare()()
            except ValueError:
                pass  # expected: the formula holds
            except Exception as e:  # noqa: BLE001
                out.append(Violation(
                    RULE, PARALLEL_PATH, 1,
                    f"[{mesh_name}] n={g['n']} failed with {type(e).__name__} ({e}), "
                    "not the ValueError the divisibility formula predicts",
                ))
            else:
                out.append(Violation(
                    RULE, PARALLEL_PATH, 1,
                    f"[{mesh_name}] n={g['n']} runs despite violating the declared "
                    f"divisibility formula n % {divisor} == 0 — the formula drifted "
                    "from the engine's actual constraint",
                ))
        for v in check_collective_budget(traced=traced, failed=failed):
            v.message = f"[{mesh_name}] {v.message}"
            out.append(v)
    return out


# ---- fixtures ------------------------------------------------------------------


def check_fixture_module(path: str) -> list[Violation]:
    """The miniature declarative form for fixtures and one-off modules:
    the module's CONTRACTS table is a list of

        {"fn": "name",
         "args": [("float32", ("n", "r")), ...],
         "out":  ("float32", ("n", "r"))  # or a list for tuple returns
         "grid": [{"n": 8, "r": 4}, ...]}

    dims are grid keys or int literals; each entry is called on
    torch.device("meta") tensors (shapes and dtypes only: no compute, no
    allocation) at every grid point."""
    import importlib.util

    import torch

    rel = os.path.basename(path)
    spec = importlib.util.spec_from_file_location(
        f"_contract_fixture_{abs(hash(path))}", path
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out: list[Violation] = []

    def resolve(shape, g):
        return tuple(d if isinstance(d, int) else g[d] for d in shape)

    def leaf(entry, g):
        dtype, shape = entry
        return (resolve(shape, g), getattr(torch, dtype))

    for decl in getattr(mod, "CONTRACTS", ()):
        fn = getattr(mod, decl["fn"])
        line = getattr(fn, "__code__", None)
        line = line.co_firstlineno if line else 1
        for g in decl["grid"]:
            args = [
                torch.empty(shape, dtype=dtype, device="meta")
                for shape, dtype in (leaf(a, g) for a in decl["args"])
            ]
            want = decl["out"]
            want = (
                tuple(leaf(o, g) for o in want) if isinstance(want, list) else leaf(want, g)
            )
            try:
                got = spec_of(fn(*args))
            except Exception as e:  # noqa: BLE001
                out.append(Violation(RULE, rel, line, f"{decl['fn']} {g}: call on meta failed: {e}"))
                continue
            for msg in leaf_mismatches(decl["fn"], got, want):
                out.append(Violation(RULE, rel, line, f"{g} {msg}"))
    return out
