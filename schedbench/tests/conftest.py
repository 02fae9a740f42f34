"""Shared fixtures of the benchmark's tests. They run on the CPU at tiny
sizes; tests marked `card` need a CUDA card and skip without one (the
card is looked for inside a fixture, never while a module is imported).

    python -m pytest schedbench/tests -q                # here, on the CPU
    python -m pytest schedbench/tests -q -m card        # on the card
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures only on the card")
    return torch.device("cuda", 0)


def tiny_cell(name: str, *, nodes: int = 48, running: int | None = None,
              backlog: int = 96, device_path: bool = False):
    """The cell `name` of BENCHMARK.json cut to a CPU test's size. With
    device_path, every cycle takes the engine (adaptive dispatch off), and
    the engine windows are 32 pods so a backlog stacks several."""
    from schedbench.run import Cell, load_cell

    cell = load_cell(name, ROOT)
    cfg = copy.deepcopy(cell.config)
    cfg["nodes"] = nodes
    cfg["running_pods"] = running if running is not None else max(cfg["running_pods"] // 250, 4)
    tr = copy.deepcopy(cell.traffic)
    tr["backlog_pods"] = backlog
    if device_path:
        cfg["scheduler"] = dict(cfg.get("scheduler", {}), adaptive_dispatch=False,
                                min_device_work=1, batch_window=32)
    return Cell(cell.name, 1, cfg, tr, cell.end_to_end, cell.per_layer)


def cpu_run(cell, seed: int = 7, seconds: float = 1.0, **kw) -> dict:
    import torch

    from schedbench.run import run_cell

    return run_cell(cell, seed, seconds, False, device="cpu", torch=torch,
                    log=lambda *a, **k: None, **kw)
