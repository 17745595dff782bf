"""The readings the check's limits are set from, many seeds in one process.

    python3 perfbench/readings.py --workload decode.ri4.clip16 \
        --seeds 1,2,3 --calls 3 [--control]

For each seed: make the corpus, set the cell's driver up, make ``calls``
calls of the timed entry and judge every output as a run does (the
program's reading); with ``--control``, judge in the same way the plain
reference computed with TF32 products put in the program's place (the
control's reading, which a sound limit must fail).  Each reading is one
JSON line.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, calls: int, control: bool, device):
    """-> [(which, numbers)] for one seed."""
    import torch

    inputs, _, _ = cell.driver.make_inputs(cell, seed)
    driver = cell.driver.Driver(cell, seed, device, inputs, lambda *a: None)
    outs = []
    for i in range(calls):
        outs.append((i, driver.call(i)))
        if driver.device.type == "cuda":
            torch.cuda.synchronize(driver.device)
    driver.close()
    got = [("program", driver.judge(outs))]
    del outs
    if control:
        low = driver.control(range(calls))
        got.append(("control", driver.judge(low)))
    return got


def main() -> int:
    from perfbench import cell as cells

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()
    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cells.load_cell(bench, args.workload)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        for which, numbers in readings(cell, seed, args.calls, args.control,
                                       dev):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "which": which, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
