"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics, read in a run of their
own.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its
limit (also the last lines of standard error).

A run needs a CUDA card (as many as the cell names) and the program,
``jpeg_tpu_torch``, beside this folder; without either it exits with a
code other than 0 and prints no result.  So it does if the process has
loaded JAX or the JAX package ``jpeg_tpu`` once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Import this folder as the package ``perfbench`` only: its modules'
# names must not shadow others' (``trace``).
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(ROOT))

from perfbench import cell as cells  # noqa: E402
from perfbench import guard, trace  # noqa: E402
from perfbench.judge import verdict  # noqa: E402

# The calls of one profiled window, and how many complete windows to keep
# (of at most PROFILE_ATTEMPTS) in a traced run.
PROFILE_KEEP = 3
PROFILE_ATTEMPTS = 8


# glibc's thresholds, fixed for the run's process (mallopt's M_TRIM_THRESHOLD
# and M_MMAP_THRESHOLD): a block up to 32 MiB comes from the heap, and
# the heap keeps up to 128 MiB of free memory at its top.  Left dynamic,
# glibc raises the mmap threshold to the largest block freed so far, so
# whether the program's host buffers are mapped, faulted in and unmapped
# on every call depends on what the process did before, and the window's
# host speed with it.
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
TRIM_BYTES, MMAP_BYTES = 128 << 20, 32 << 20


def fix_allocator() -> bool:
    """Fix glibc's heap thresholds for this process; False where the C
    library has no ``mallopt``."""
    import ctypes

    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return False
    return bool(mallopt(M_TRIM_THRESHOLD, TRIM_BYTES)
                and mallopt(M_MMAP_THRESHOLD, MMAP_BYTES))


def log(*a) -> None:
    print(*a, flush=True)


@dataclass
class Run:
    """What the metric readers read."""

    cell: cells.Cell
    kind: str
    setup_s: float
    window: cells.Window
    frames_per_call: int
    pixels_per_call: int
    profiled: List[trace.Window] = field(default_factory=list)


def _sync(device) -> Callable[[], None]:
    import torch

    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float, say: Callable = log) -> dict:
    """One run of ``cell`` on ``device`` -> the result object."""
    import torch

    inputs, corpus_s, made = cell.driver.make_inputs(cell, seed)
    how = "made by a child process, then read" if made else "read"
    say(f"corpus: {corpus_s:.3f} s ({how}), kept out of setup_s")
    driver = cell.driver.Driver(cell, seed, device, inputs, say)
    del inputs
    sync = _sync(driver.device)
    t_first = time.perf_counter()
    setup_s = t_first - t_start - corpus_s
    say(f"setup: {setup_s} s to the first timed call")
    keep = int(cell.traffic["check_calls"])
    profiled: List[trace.Window] = []
    first = 0
    if traced:
        from jpeg_tpu_torch.utils.metrics import default_metrics

        profiled, first = trace.profiled_windows(
            driver.call, sync, driver.work, int(cell.traffic["profile_calls"]),
            PROFILE_KEEP, PROFILE_ATTEMPTS, say)
        before = cells.snapshot(default_metrics)
        window = cells.measure(driver.call, sync, seconds, keep, seed, first)
        window.spans, window.counters = cells.delta(
            before, cells.snapshot(default_metrics))
    else:
        window = cells.measure(driver.call, sync, seconds, keep, seed)
    p95, n, beyond = cells.p95_and_count(window.latencies)
    say(f"window: {n} calls in {window.seconds} s, {window.failed} failed; "
        f"p95 {p95 * 1e3} ms with {beyond} calls beyond it")
    for e in window.errors:
        say(f"error: {e}")
    dev = driver.device
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    driver.close()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = driver.judge([(i, out) for i, out in window.samples
                            if out is not None])
    say(f"check: {len(window.samples)} sampled calls in "
        f"{time.perf_counter() - t0:.3f} s")
    ok, table = verdict(numbers, cell.config["limits"][cell.driver.KIND])
    run = Run(cell, cell.driver.KIND, setup_s, window, driver.frames_per_call,
              driver.pixels_per_call, profiled)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        kind = "layer_metrics" if traced else "e2e_metrics"
        value = cell.reader(kind, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": bool(ok and window.failed == 0 and
                              window.samples),
              "attempted": n, "failed": window.failed,
              "metrics": metrics, "device": device_info}
    if traced:
        device_info["busy_s"] = sum(w.busy_us for w in profiled) / 1e6
        device_info["window_s"] = sum(w.window_us for w in profiled) / 1e6
        bd = trace.breakdown(profiled)
        if bd is not None:
            result["breakdown"] = bd
    result["checks"] = table
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed = fix_allocator()

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cells.load_cell(bench, args.workload)
    chips = {w["name"]: w for w in bench["workloads"]}[args.workload]["chips"]
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(HERE / ".cache" / sub)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    log(f"host allocator: thresholds "
        f"{'fixed' if fixed else 'left as they are (no mallopt)'}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    found = guard.loaded_forbidden()
    if found:
        print(f"perfbench: the process loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
