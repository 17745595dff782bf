"""The result line's keys, and the runs that must print none."""

import json
import shutil
import subprocess
import sys

import pytest

from perfbench.tests import tiny

CMD = ["perfbench/run.py", "--workload", "decode.ri4.clip16", "--seed",
       str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"]


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_result_keys(traced):
    res = tiny.run_cpu(tiny.cell("encode.ri4.clip16"), traced=traced)
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if traced:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["metrics"]) <= {"finalize_ms.encode",
                                       "pull_ms.encode",
                                       "kernel_roofline.encode",
                                       "device_idle.encode"}
        assert "finalize_ms.encode" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"encode_Mpix_s", "encode_p95_ms",
                                       "setup_s"}
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def _no_card_run(cwd):
    return subprocess.run([sys.executable, *CMD], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _no_card_run(tiny.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_no_program_no_result(tmp_path):
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _no_card_run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == "" or not out.stdout.strip().splitlines()[
        -1].startswith("{")
