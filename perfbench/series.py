"""Run cells of the benchmark many times, one process a run, and sum up.

    python3 perfbench/series.py --out chiprun_out/perfbench/set1 \
        --runs decode.ri4.clip16:11,12,13 --seconds 10 [--trace 1]

runs ``perfbench/run.py`` once for each (workload, seed) in turn, in the
order given, writes each run's output to ``<out>/<workload>.<seed>.log``
and its result line to ``<out>/results.jsonl``, and prints each run's
metrics and, per workload and metric, the median and the spread (the
interquartile range over the median) of the runs.  It is a tool for
setting and checking the bounds; the benchmark's own runs do not use it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(ROOT))

from perfbench.stats import spread  # noqa: E402

# The contract's limit on one run of a cell, a checkout's first included.
RUN_TIMEOUT_S = 1200


def parse_runs(specs):
    """``name:seed,seed,...`` items -> [(name, seed)] in order."""
    out = []
    for spec in specs:
        name, seeds = spec.split(":")
        out += [(name, int(s)) for s in seeds.split(",")]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--runs", nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    by: dict = {}
    for name, seed in parse_runs(args.runs):
        t0 = time.perf_counter()
        cmd = [sys.executable, str(HERE / "run.py"), "--workload", name,
               "--seed", str(seed), "--seconds", str(args.seconds),
               "--trace", str(args.trace)]
        try:
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                               timeout=RUN_TIMEOUT_S)
            rc, so, se = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, so, se = 124, e.stdout or "", e.stderr or ""
            so = so.decode() if isinstance(so, bytes) else so
            se = se.decode() if isinstance(se, bytes) else se
        wall = time.perf_counter() - t0
        (out / f"{name}.{seed}.log").write_text(
            f"$ {' '.join(cmd)}\nrc {rc}, {wall:.1f} s\n--- stdout\n{so}"
            f"--- stderr\n{se}")
        lines = so.strip().splitlines()
        res = None
        if rc == 0 and lines:
            try:
                res = json.loads(lines[-1])
            except json.JSONDecodeError:
                res = None
        with open(out / "results.jsonl", "a") as f:
            f.write(json.dumps({"workload": name, "seed": seed, "rc": rc,
                                "wall_s": wall, "result": res}) + "\n")
        if res is None:
            print(f"{name} seed {seed}: rc {rc}, {wall:.1f} s, no result; "
                  f"stderr tail: {se[-1500:]}", flush=True)
            continue
        vals = {k: v["value"] for k, v in res["metrics"].items()}
        checks = {k: v["value"] for k, v in res["checks"].items()}
        print(f"{name} seed {seed}: rc {rc}, {wall:.1f} s, correct "
              f"{res['correct']}, attempted {res['attempted']}, metrics "
              f"{vals}, checks {checks}, peak "
              f"{res['device']['memory_peak_bytes']}", flush=True)
        for k, v in vals.items():
            by.setdefault((name, k), []).append(v)
    for (name, k), vs in sorted(by.items()):
        print(f"summary {name} {k}: n {len(vs)} median "
              f"{statistics.median(vs)} spread "
              f"{spread(vs) if len(vs) > 1 and statistics.median(vs) else None}"
              f" values {vs}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
