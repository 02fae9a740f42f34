"""The explicit-state bounded model checker under analysis/model/.

Models are finite-state by construction (every variable ranges over a
small declared domain; environment churn is budget-bounded), so the
checker can EXHAUST the reachable state space and prove the declared
invariants rather than sample them:

- **States** are flat dicts of hashable variable values; a transition
  is a (guard, effect) pair plus declared read/write sets — the effect
  returns only the variables it changes, and the checker validates the
  writes against the declaration at fire time (a lying annotation would
  make the reduction below unsound, so it is an error, not a comment).
- **Exploration** is depth-first and fully deterministic: transitions
  fire in declaration order, so the same model yields the same
  traversal, the same counterexamples, byte for byte, on every run.
- **Partial-order reduction** is the sleep-set algorithm (Godefroid):
  after exploring transition t from state s, t is put to sleep for the
  subtrees of t's independent siblings — the interleaving t;u is
  explored, u;t is not, when the two commute. Sleep sets prune
  redundant TRANSITIONS, never states: every reachable state is still
  visited, so checking invariants at each visited state stays sound
  (tests/test_model.py pins POR state sets == full state sets on every
  shipped model). Two transitions are independent iff they belong to
  different processes and neither writes what the other reads or
  writes.
- **Invariants** are checked at every state on first visit; a
  violation renders the event schedule from the initial state (the
  parent pointers of first discovery — deterministic, shortest-ish).
- **Convergence properties** ("epoch desync always converges to a full
  resend") are AF checks: from every reachable `trigger` state, every
  maximal path must reach a `goal` state. These are evaluated on the
  FULL edge relation (a reduced edge set could hide a goal-avoiding
  cycle), which the checker re-explores without POR when a model
  declares any — the models are small enough that soundness is cheaper
  than cleverness. A violation renders the path into the goal-avoiding
  cycle (livelock) or dead end.
- **Budgets** bound states and wall time; a model that does not
  exhaust its space inside them is reported un-exhausted and the
  caller (CLI exit 3, lint violation) fails loudly — a bounded proof
  that silently covered half the space would be worse than none.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Transition:
    """One protocol step. `guard(state) -> bool`, `effect(state) ->
    dict of updated variables` (only variables in `writes`). `reads`
    must cover every variable the guard or effect examines — the
    independence relation (and so the reduction) is computed from these
    declarations."""

    name: str
    process: str
    guard: object
    effect: object
    reads: frozenset
    writes: frozenset
    # code sites this transition abstracts (anchors.Anchor); verified
    # against the live ModuleIndex by the drift layer
    anchors: tuple = ()


@dataclass(frozen=True)
class Invariant:
    """Must hold in EVERY reachable state."""

    name: str
    check: object
    description: str = ""


@dataclass(frozen=True)
class Convergence:
    """AF property: from every reachable state satisfying `trigger`,
    every maximal path reaches a state satisfying `goal`."""

    name: str
    trigger: object
    goal: object
    description: str = ""


@dataclass(frozen=True)
class ProtocolModel:
    name: str
    description: str
    init: dict
    transitions: tuple
    invariants: tuple = ()
    convergences: tuple = ()
    # where findings anchor in lint output (repo-relative path, line)
    origin: tuple = ("kubernetes_scheduler_tpu_torch/analysis/model/protocols.py", 1)


@dataclass
class ModelViolation:
    model: str
    kind: str          # "invariant" | "convergence" | "budget"
    name: str
    message: str
    schedule: list = field(default_factory=list)  # rendered event lines

    def render(self) -> str:
        out = [f"{self.model}: {self.kind} `{self.name}`: {self.message}"]
        out.extend(f"    {line}" for line in self.schedule)
        return "\n".join(out)


@dataclass
class CheckResult:
    model: str
    states: int
    transitions_fired: int
    transitions_slept: int
    exhausted: bool
    violations: list
    seconds: float

    @property
    def ok(self) -> bool:
        return self.exhausted and not self.violations


def _key(state: dict) -> tuple:
    return tuple(sorted(state.items()))


def _fmt_state(state: dict, keys=None) -> str:
    items = sorted(state.items()) if keys is None else [
        (k, state[k]) for k in keys if k in state
    ]
    return "{" + ", ".join(f"{k}={v!r}" for k, v in items) + "}"


def _independent(a: Transition, b: Transition) -> bool:
    if a.process == b.process:
        return False
    return not (
        (a.writes & (b.reads | b.writes))
        or (b.writes & a.reads)
    )


def _apply(t: Transition, state: dict) -> dict:
    updates = t.effect(state)
    bad = set(updates) - set(t.writes)
    if bad:
        raise ValueError(
            f"transition `{t.name}` wrote undeclared variables "
            f"{sorted(bad)} — its `writes` set is wrong, which would "
            "make the partial-order reduction unsound"
        )
    new = dict(state)
    new.update(updates)
    return new


def _schedule_to(parents: dict, key: tuple, init_key: tuple) -> list[str]:
    """Render the first-discovery path init -> key as event lines."""
    names = []
    k = key
    while k != init_key:
        pk, tname = parents[k]
        names.append(tname)
        k = pk
    names.reverse()
    lines = [f"schedule ({len(names)} events from init):"]
    lines.extend(f"{i + 1}. {n}" for i, n in enumerate(names))
    return lines


@dataclass
class _Exploration:
    states: dict          # key -> state dict (insertion = discovery order)
    parents: dict         # key -> (parent key, transition name)
    edges: dict | None    # key -> [(transition name, succ key)] (full runs)
    fired: int
    slept: int
    exhausted: bool
    init_key: tuple


def _explore(
    model: ProtocolModel,
    *,
    por: bool,
    record_edges: bool,
    max_states: int,
    deadline: float | None,
) -> _Exploration:
    init = dict(model.init)
    init_key = _key(init)
    states = {init_key: init}
    parents: dict = {}
    edges: dict | None = {} if record_edges else None
    # sleep sets each state has been EXPANDED under (Godefroid's
    # sleep-sets-with-state-matching): re-expand only when arriving
    # with a sleep set no previous expansion subsumes — a previous
    # expansion under S' ⊆ S already fired everything S would. This is
    # what keeps sleep sets sound next to state caching: every
    # reachable state is still visited.
    expanded: dict[tuple, list[frozenset]] = {}
    indep: dict[tuple, bool] = {}
    for a in model.transitions:
        for b in model.transitions:
            indep[(a.name, b.name)] = _independent(a, b)
    fired = 0
    slept = 0
    exhausted = True
    edge_seen: set = set()
    # DFS stack of (state key, sleep set); deterministic order
    stack: list[tuple[tuple, frozenset]] = [(init_key, frozenset())]
    expanded[init_key] = [frozenset()]
    while stack:
        if len(states) > max_states or (
            deadline is not None and time.monotonic() > deadline
        ):
            exhausted = False
            break
        skey, sleep = stack.pop()
        state = states[skey]
        cur_sleep = set(sleep)
        for t in model.transitions:
            if not t.guard(state):
                continue
            if t.name in cur_sleep:
                slept += 1
                continue
            succ = _apply(t, state)
            ckey = _key(succ)
            fired += 1
            if edges is not None and (skey, t.name) not in edge_seen:
                edge_seen.add((skey, t.name))
                edges.setdefault(skey, []).append((t.name, ckey))
            if ckey not in states:
                states[ckey] = succ
                parents[ckey] = (skey, t.name)
            child_sleep = frozenset(
                u for u in cur_sleep if por and indep[(t.name, u)]
            )
            prev = expanded.setdefault(ckey, [])
            if not any(p <= child_sleep for p in prev):
                prev.append(child_sleep)
                stack.append((ckey, child_sleep))
            cur_sleep.add(t.name)
    return _Exploration(
        states=states, parents=parents, edges=edges, fired=fired,
        slept=slept, exhausted=exhausted, init_key=init_key,
    )


def _check_invariants(model: ProtocolModel, ex: _Exploration) -> list:
    out = []
    seen_inv: set[str] = set()
    for skey, state in ex.states.items():
        for inv in model.invariants:
            if inv.name in seen_inv:
                continue  # first (discovery-order) counterexample only
            if inv.check(state):
                continue
            seen_inv.add(inv.name)
            sched = _schedule_to(ex.parents, skey, ex.init_key)
            sched.append(f"reaches {_fmt_state(state)}")
            out.append(
                ModelViolation(
                    model=model.name, kind="invariant", name=inv.name,
                    message=inv.description or "invariant violated",
                    schedule=sched,
                )
            )
    return out


def _sccs(nodes: list, succ: dict) -> list[list]:
    """Tarjan (iterative), deterministic order."""
    index: dict = {}
    low: dict = {}
    on_stack: set = set()
    stack: list = []
    out: list[list] = []
    counter = [0]
    for root in nodes:
        if root in index:
            continue
        work = [(root, iter(succ.get(root, ())))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for child in it:
                if child not in index:
                    index[child] = low[child] = counter[0]
                    counter[0] += 1
                    stack.append(child)
                    on_stack.add(child)
                    work.append((child, iter(succ.get(child, ()))))
                    advanced = True
                    break
                if child in on_stack:
                    low[node] = min(low[node], index[child])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                out.append(comp)
    return out


def _check_convergences(model: ProtocolModel, ex: _Exploration) -> list:
    """AF(trigger -> goal) on the FULL edge relation. A violation is a
    trigger state from which some maximal path never meets goal: a path
    into a goal-avoiding cycle (livelock) or a goal-avoiding dead end."""
    assert ex.edges is not None
    out = []
    goal_cache: dict[str, dict] = {}
    for conv in model.convergences:
        is_goal = {
            k: bool(conv.goal(s)) for k, s in ex.states.items()
        }
        goal_cache[conv.name] = is_goal
        # subgraph of non-goal states
        sub_succ: dict = {}
        for k, outs in ex.edges.items():
            if is_goal[k]:
                continue
            sub_succ[k] = [
                (t, c) for t, c in outs if not is_goal[c]
            ]
        sub_nodes = [k for k in ex.states if not is_goal[k]]
        succ_keys = {
            k: [c for _, c in v] for k, v in sub_succ.items()
        }
        # bad seeds: non-goal dead ends (no successors AT ALL) and
        # states on cycles inside the non-goal subgraph
        seeds: set = set()
        for k in sub_nodes:
            if not ex.edges.get(k):
                seeds.add(k)
        for comp in _sccs(sub_nodes, succ_keys):
            if len(comp) > 1:
                seeds.update(comp)
            else:
                k = comp[0]
                if k in succ_keys.get(k, ()):  # self-loop
                    seeds.add(k)
        # states (within the non-goal subgraph) that can reach a seed
        rev: dict = {}
        for k, outs in succ_keys.items():
            for c in outs:
                rev.setdefault(c, []).append(k)
        bad = set(seeds)
        frontier = list(seeds)
        while frontier:
            k = frontier.pop()
            for p in rev.get(k, ()):
                if p not in bad:
                    bad.add(p)
                    frontier.append(p)
        # first (discovery-order) triggering bad state
        witness = None
        for k, s in ex.states.items():
            if k in bad and conv.trigger(s):
                witness = k
                break
        if witness is None:
            continue
        sched = _schedule_to(ex.parents, witness, ex.init_key)
        sched.append(f"reaches trigger state {_fmt_state(ex.states[witness])}")
        sched.extend(_lasso_from(witness, sub_succ, ex, seeds, succ_keys))
        out.append(
            ModelViolation(
                model=model.name, kind="convergence", name=conv.name,
                message=(
                    conv.description
                    or "a maximal path from a trigger state never reaches "
                    "the goal"
                ),
                schedule=sched,
            )
        )
    return out


def _lasso_from(start, sub_succ, ex, seeds, succ_keys) -> list[str]:
    """Render the goal-avoiding continuation: BFS (deterministic) to the
    nearest seed, then one goal-avoiding cycle or the dead end."""
    par = {start: None}
    order = [start]
    seed = start if start in seeds else None
    i = 0
    while seed is None and i < len(order):
        k = order[i]
        i += 1
        for t, c in sub_succ.get(k, ()):
            if c not in par:
                par[c] = (k, t)
                order.append(c)
                if c in seeds:
                    seed = c
                    break
    lines = []
    if seed is not None and seed != start:
        path = []
        k = seed
        while par[k] is not None:
            pk, t = par[k]
            path.append(t)
            k = pk
        path.reverse()
        lines.append("then (staying goal-free): " + " -> ".join(path))
    tail = seed if seed is not None else start
    if not ex.edges.get(tail):
        lines.append(f"dead end at {_fmt_state(ex.states[tail])}")
        return lines
    # one cycle through `tail` inside the non-goal subgraph
    cyc_par = {tail: None}
    cyc_order = [tail]
    closed = None
    j = 0
    while closed is None and j < len(cyc_order):
        k = cyc_order[j]
        j += 1
        for t, c in sub_succ.get(k, ()):
            if c == tail:
                closed = (k, t)
                break
            if c not in cyc_par:
                cyc_par[c] = (k, t)
                cyc_order.append(c)
    if closed is not None:
        k, t = closed
        cyc = [t]
        while cyc_par[k] is not None:
            pk, pt = cyc_par[k]
            cyc.append(pt)
            k = pk
        cyc.reverse()
        lines.append(
            "livelock cycle (repeats forever): " + " -> ".join(cyc)
        )
    return lines


def check_model(
    model: ProtocolModel,
    *,
    por: bool = True,
    max_states: int = 200_000,
    max_seconds: float | None = 30.0,
    mutate=None,
) -> CheckResult:
    """Exhaust the model's bounded state space and check every declared
    property. `mutate(model) -> model` (mutants.py) swaps in a seeded
    bug before checking."""
    if mutate is not None:
        model = mutate(model)
    t0 = time.monotonic()
    deadline = t0 + max_seconds if max_seconds is not None else None
    # record edges only when THIS exploration's relation will be used:
    # convergence checking always re-explores without POR (below), so a
    # reduced pass never needs them
    ex = _explore(
        model, por=por, record_edges=not por,
        max_states=max_states, deadline=deadline,
    )
    violations: list[ModelViolation] = []
    if not ex.exhausted:
        violations.append(
            ModelViolation(
                model=model.name, kind="budget", name="state-budget",
                message=(
                    f"state space not exhausted within max_states="
                    f"{max_states} / max_seconds={max_seconds} "
                    f"({len(ex.states)} states explored) — the bounded "
                    "proof is incomplete"
                ),
            )
        )
    violations.extend(_check_invariants(model, ex))
    if ex.exhausted and model.convergences:
        if ex.edges is None or por:
            # convergence needs the FULL edge relation: re-explore
            # without reduction (a reduced edge set could hide a
            # goal-avoiding cycle)
            ex_full = _explore(
                model, por=False, record_edges=True,
                max_states=max_states, deadline=deadline,
            )
        else:
            ex_full = ex
        if ex_full.exhausted:
            violations.extend(_check_convergences(model, ex_full))
        else:
            violations.append(
                ModelViolation(
                    model=model.name, kind="budget", name="state-budget",
                    message=(
                        "full (unreduced) re-exploration for convergence "
                        "checking blew the budget"
                    ),
                )
            )
    return CheckResult(
        model=model.name,
        states=len(ex.states),
        transitions_fired=ex.fired,
        transitions_slept=ex.slept,
        exhausted=ex.exhausted,
        violations=violations,
        seconds=time.monotonic() - t0,
    )
