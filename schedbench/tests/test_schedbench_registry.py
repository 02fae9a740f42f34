"""A configuration, a traffic mix and a metric added as files are found by
name, with no edit of any file already there."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from schedbench.tests.conftest import ROOT

SCRIPT = """
import json, sys
sys.path[:0] = ['.', ROOT]
import torch
from schedbench.run import load_cell, run_cell
cell = load_cell('tiny.trickle', __import__('pathlib').Path('.'))
assert [m['name'] for m in cell.per_layer] == ['cycles_seen.tiny']
out = run_cell(cell, 3, 0.5, False, device='cpu', torch=torch, log=lambda *a, **k: None)
print(json.dumps({'correct': out['correct'], 'metrics': sorted(out['metrics'])}))
"""


def test_schedbench_new_files_are_found_by_name(tmp_path):
    tree = tmp_path / "tree"
    shutil.copytree(ROOT / "schedbench", tree / "schedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tree / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tree / "schedbench").rglob("*") if p.is_file()}
    bench_before = (tree / "BENCHMARK.json").read_text()
    base = json.loads((tree / "schedbench/configs/basic-5k.json").read_text())
    base.update(name="tiny", nodes=24, running_pods=6)
    (tree / "schedbench/configs/tiny.json").write_text(json.dumps(base))
    (tree / "schedbench/traffic/trickle.json").write_text(
        json.dumps({"kind": "closed_backlog", "backlog_pods": 20, "pool_pods_per_s": 400}))
    (tree / "schedbench/metrics/cycles_seen.tiny.py").write_text(
        "def read(run):\n    return float(len(run.rec.window()))\n")
    bench = json.loads(bench_before)
    bench["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                             "file": "schedbench/configs/tiny.json", "reduced": ["nodes"],
                             "why": "throwaway"})
    bench["workloads"].append({"name": "tiny.trickle", "config": "tiny",
                               "traffic": "trickle", "chips": 1, "why": "throwaway"})
    bench["end_to_end"][0]["workloads"].append("tiny.trickle")
    bench["per_layer"].append({"name": "cycles_seen.tiny", "unit": "cycles",
                               "better": "higher", "source": "program_counter",
                               "layer": "host loop", "moves": "pods_per_s",
                               "workloads": ["tiny.trickle"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data
    script = f"ROOT = {str(ROOT)!r}\n" + SCRIPT
    out = subprocess.run([sys.executable, "-c", script], cwd=tree, capture_output=True,
                         text=True, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"correct": True, "metrics": ["pods_per_s", "setup_s"]}
    trace = script.replace("0.5, False", "0.5, True").replace(
        "print(json.dumps({'correct'", "assert out['metrics']['cycles_seen.tiny']['value'] > 0\n"
        "print(json.dumps({'correct'")
    out = subprocess.run([sys.executable, "-c", trace], cwd=tree, capture_output=True,
                         text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
