"""Readings that set the limits of schedbench/limits.json, on the card.

    python3 -m schedbench.control --workload <cell> --seeds 1,2,3 --seconds <s>

For each seed, one run of the cell (set-up and a window of `--seconds`) in
this process, with the reference's numbers for the program's bindings and
for the control (run_cell with control=True: the reference computed in
bfloat16 in the program's place, reference.control_check), each through
the same verdict. Prints one JSON line per seed and a last line with, for
each number the control reads, the program's highest reading and the
control's lowest. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def readings(cell, seeds, seconds: float, *, device, torch) -> list:
    """[result of run_cell with control=True] for each seed."""
    from schedbench.run import run_cell

    return [run_cell(cell, seed, seconds, False, device=device, torch=torch,
                     log=lambda *a, **k: None, control=True) for seed in seeds]


def summary(results: list) -> dict:
    """{number: {program_max, control_min}} over the numbers the control
    reads, and whether every program run and no control run was correct."""
    names = results[0]["control"]["check"]
    return {
        "program_correct": all(r["correct"] for r in results),
        "control_correct_any": any(r["control"]["correct"] for r in results),
        **{k: {"program_max": max(r["check"][k]["value"] for r in results),
               "control_min": min(r["control"]["check"][k]["value"] for r in results)}
           for k in names},
    }


def main(argv=None) -> int:
    from schedbench.run import cache_dirs, load_cell

    ap = argparse.ArgumentParser(prog="python3 -m schedbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cache_dirs(root)
    cell = load_cell(args.workload, root)
    import torch

    if not torch.cuda.is_available():
        print("schedbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    results = readings(cell, seeds, args.seconds, device=torch.device("cuda", 0), torch=torch)
    for seed, res in zip(seeds, results):
        print(json.dumps({"seed": seed, "correct": res["correct"], "check": res["check"],
                          "control": res["control"], "metrics": res["metrics"]}), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(results), **summary(results)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
