"""Seeded thread/determinism mutants: families 17-18 must catch each one.

The mutation lesson applied to the concurrency layer: a race
detector that has never caught a race is an assertion, not a tool.
BASE below is a miniature mirror — a worker thread filling a
lock-guarded dirty-set, an Event publishing a counter to the serving
thread, a lock-covered check-then-act cache latch, a join-then-read
shutdown, and a journal record built from `sorted()` rows plus a
sanctioned `wall_time` stamp — clean under BOTH new families by
construction. Each mutant re-introduces one real bug class and the
family that owns it MUST report it:

- `drop-mirror-lock`: the lock around the dirty-set insert deleted —
  the writer races the `sorted(self._dirty)` reader. thread-race
  (lockset discharge gone, and the Event fired BEFORE these writes so
  no happens-before edge covers them);
- `event-set-before-write`: `self._ready.set()` hoisted above the
  write it publishes — the waiter can read the stale value. thread-race
  (the set-then-write order breaks the Event publication discharge);
- `unsorted-dirty-iter`: `sorted(self._dirty)` weakened to
  `list(self._dirty)` — set iteration order leaks into the journal
  record. determinism-taint (set-order source reaching a record field
  through the snapshot return);
- `wallclock-journal-field`: a decision field (`seq`) stamped from
  `time.time()` — only declared timing fields (`wall_time`,
  `*_seconds`) may carry the clock. determinism-taint;
- `latch-check-then-act`: the lock around the cache latch deleted —
  two threads both observe `cache is None` and both initialize.
  thread-race (check-then-act + lock-free cross-thread access pair);
- `unjoined-shutdown-read`: `close()` stops joining the worker before
  reading its final counter — shutdown reads a value the still-running
  thread may yet write. thread-race (the join happens-before edge was
  the only discharge for that pair).

`check_thread_mutants()` runs on every full-repo lint next to the SPMD
harness: the unmutated BASE must be clean under both families, and a
survived mutant is itself a lint violation — the analyzer lost its
teeth for that bug class. tests/test_torch_spmd.py asserts the harness
one mutant at a time by name, with the rendered access-pair evidence,
and holds each mutant's findings to the JAX package's harness.
"""

from __future__ import annotations

import os
import tempfile

from kubernetes_scheduler_tpu_torch.analysis.core import Violation

RULE = "thread-mutant"

MUTANTS_PATH = "kubernetes_scheduler_tpu_torch/analysis/thread_mutants.py"

FAMILIES = ("thread-race", "determinism-taint")

# --changed-only runs re-arm the harness when the closure touches the
# threaded layers or the analyzer itself (same shape as contracts.SURFACE)
SURFACE = (
    "kubernetes_scheduler_tpu_torch/analysis/threads.py",
    "kubernetes_scheduler_tpu_torch/analysis/thread_mutants.py",
    "kubernetes_scheduler_tpu_torch/analysis/rules/thread_race.py",
    "kubernetes_scheduler_tpu_torch/analysis/rules/determinism_taint.py",
    "kubernetes_scheduler_tpu_torch/host/*.py",
    "kubernetes_scheduler_tpu_torch/kube/*.py",
    "kubernetes_scheduler_tpu_torch/bridge/*.py",
    "kubernetes_scheduler_tpu_torch/trace/*.py",
)

# the miniature mirror every mutant perturbs
BASE = '''\
"""Thread-mutant base: a miniature mirror with one worker thread."""

import threading
import time

JOURNAL = []


def record_cycle(rec):
    JOURNAL.append(rec)


class MiniMirror:
    def __init__(self, seed):
        self.seed = seed
        self._lock = threading.Lock()
        self._ready = threading.Event()
        self._dirty = set()
        self.published = 0
        self.cache = None
        self._worker = None

    def start(self):
        self._worker = threading.Thread(target=self._pump, daemon=True)
        self._worker.start()

    def _pump(self):
        self.published = self.seed + 4
        self._ready.set()
        for seq in range(4):
            self.ensure_cache()
            with self._lock:
                self._dirty.add("row-%d" % seq)

    def ensure_cache(self):
        with self._lock:
            if self.cache is None:
                self.cache = {}
            return self.cache

    def snapshot(self):
        self._ready.wait()
        count = self.published
        with self._lock:
            rows = sorted(self._dirty)
        return rows, count

    def close(self):
        if self._worker is not None:
            self._worker.join(timeout=1.0)
        return self.published


def drive(n):
    m = MiniMirror(seed=n)
    m.start()
    m.ensure_cache()
    rows, count = m.snapshot()
    rec = {"seq": n, "rows": rows, "count": count,
           "wall_time": time.time()}
    record_cycle(rec)
    return m.close()
'''

# name -> (literal pattern, replacement, family that MUST catch it)
THREAD_MUTANTS = {
    "drop-mirror-lock": (
        "            with self._lock:\n"
        '                self._dirty.add("row-%d" % seq)\n',
        '            self._dirty.add("row-%d" % seq)\n',
        "thread-race",
    ),
    "event-set-before-write": (
        "        self.published = self.seed + 4\n"
        "        self._ready.set()\n",
        "        self._ready.set()\n"
        "        self.published = self.seed + 4\n",
        "thread-race",
    ),
    "unsorted-dirty-iter": (
        "            rows = sorted(self._dirty)\n",
        "            rows = list(self._dirty)\n",
        "determinism-taint",
    ),
    "wallclock-journal-field": (
        '    rec = {"seq": n, "rows": rows, "count": count,\n',
        '    rec = {"seq": int(time.time()), "rows": rows, "count": count,\n',
        "determinism-taint",
    ),
    "latch-check-then-act": (
        "        with self._lock:\n"
        "            if self.cache is None:\n"
        "                self.cache = {}\n"
        "            return self.cache\n",
        "        if self.cache is None:\n"
        "            self.cache = {}\n"
        "        return self.cache\n",
        "thread-race",
    ),
    "unjoined-shutdown-read": (
        "        if self._worker is not None:\n"
        "            self._worker.join(timeout=1.0)\n"
        "        return self.published\n",
        "        return self.published\n",
        "thread-race",
    ),
}


def mutate(name: str) -> str:
    pattern, replacement, _ = THREAD_MUTANTS[name]
    mutated = BASE.replace(pattern, replacement)
    if mutated == BASE:
        raise ValueError(
            f"mutant {name!r}: pattern no longer matches the BASE "
            "module — the harness drifted from its own source"
        )
    return mutated


def _findings(source: str, family: str, workdir: str) -> list:
    """One family's findings on `source` (written to a scratch module so
    the normal lint path — index build, model build, rule — runs
    unchanged)."""
    from kubernetes_scheduler_tpu_torch.analysis.core import run_lint

    path = os.path.join(workdir, "thread_mutant_mod.py")
    with open(path, "w", encoding="utf-8") as f:
        f.write(source)
    return [v for v in run_lint([path], rules=[family]) if not v.waived]


def run_thread_mutant(name: str, workdir: str | None = None) -> dict:
    """{family: [findings]} for one mutant, across both families."""
    source = mutate(name)
    with tempfile.TemporaryDirectory() as tmp:
        wd = workdir or tmp
        return {fam: _findings(source, fam, wd) for fam in FAMILIES}


def check_thread_mutants() -> list[Violation]:
    """The lint entry point: [] when the unmutated base is clean under
    both families and every mutant is caught by the family that owns
    its bug class. A survived mutant means the thread model / taint
    tracker lost its teeth — a checker regression, not a code bug."""
    out: list[Violation] = []
    with tempfile.TemporaryDirectory() as tmp:
        for fam in FAMILIES:
            for v in _findings(BASE, fam, tmp):
                out.append(Violation(
                    RULE, MUTANTS_PATH, 1,
                    "the UNMUTATED thread-mutant base module is dirty "
                    f"under {fam} (every catch would be vacuous): "
                    f"{v.message}",
                ))
        if out:
            return out
        for name, (_, _, family) in THREAD_MUTANTS.items():
            try:
                source = mutate(name)
                got = _findings(source, family, tmp)
            except Exception as e:  # noqa: BLE001
                out.append(Violation(
                    RULE, MUTANTS_PATH, 1,
                    f"seeded thread mutant `{name}` harness error: {e}",
                ))
                continue
            if not got:
                out.append(Violation(
                    RULE, MUTANTS_PATH, 1,
                    f"seeded thread mutant `{name}` SURVIVED the "
                    f"{family} family — the analyzer lost its teeth for "
                    f"this bug class (see THREAD_MUTANTS[{name!r}])",
                ))
    return out
