"""On the card: one short run of each cell, as the benchmark runs it.

Run there with ``python3 -m pytest perfbench/tests -m chip``; skips on a
host without a card."""

import json
import subprocess
import sys

import pytest

from perfbench.tests import tiny


@pytest.mark.chip
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      tiny.BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 99), "--seconds", "2", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
