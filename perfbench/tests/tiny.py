"""Small cells for the benchmark's CPU tests: the committed cells with
frames cut to a size a test run holds, and the program's plain versions
on the CPU in place of its kernels."""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from perfbench import cell as cells
from perfbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(workload: str, width: int = 64, height: int = 48,
         bench: dict = BENCH, root: Path = cells.HERE) -> cells.Cell:
    c = cells.load_cell(bench, workload, root)
    c.config["width"], c.config["height"] = width, height
    return c


def run_cpu(c: cells.Cell, seed: int = 2 ** 31 + 5, seconds: float = 0.3,
            traced: bool = False, lines=None) -> dict:
    """One run of ``c`` on the CPU, in this process."""
    say = (lambda *a: lines.append(" ".join(map(str, a)))) \
        if lines is not None else (lambda *a: None)
    return run.run_cell(c, seed, seconds, traced, torch.device("cpu"),
                        time.perf_counter(), say=say)
