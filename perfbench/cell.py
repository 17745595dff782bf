"""One cell of ``BENCHMARK.json``, found by name, and one run of it.

Everything that belongs to one configuration, traffic mix, driver or
metric is a file of its own, found by its name:

- ``configs/<config>.json``: the deployment (sizes, source, ``reduced``,
  ``assumed``, its plain reference by name, the limits of the check);
- ``traffic/<traffic>.json``: the traffic mix (its driver by name, clip
  length, contents, chunk, the calls sampled for the check);
- ``drivers/<driver>.py``: the entry a window drives;
- ``references/<reference>.py``: the configuration's plain reference;
- ``e2e_metrics/<metric>.py`` and ``layer_metrics/<metric>.py``: one
  reader each, ``read(run) -> float or None``; the metrics of one
  quantity in cells of other kinds (``device_idle.decode``,
  ``device_idle.encode``) share ``<name up to its first dot>.py``.

A later change adds a configuration, a traffic mix or a metric as new
files and new entries in ``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import stats

HERE = Path(__file__).resolve().parent
TAIL_PCT = 95.0


def load_module(path: Path) -> ModuleType:
    """Import a file by path, once, under a name made from the path."""
    path = path.resolve()
    name = "perfbench_file_" + hashlib.sha256(
        str(path).encode()).hexdigest()[:16]
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    config: dict
    traffic: dict
    driver: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    @property
    def reference(self) -> ModuleType:
        from .corpus import reference

        return reference(self.config)

    def reader(self, kind: str, metric: str) -> ModuleType:
        """``<kind>/<metric>.py``, or where there is none, the reader the
        metrics of one quantity share: ``<kind>/<name up to its first
        dot>.py`` (``device_idle.py`` reads ``device_idle.live``)."""
        own = self.root / kind / f"{metric}.py"
        shared = self.root / kind / f"{metric.split('.')[0]}.py"
        return load_module(own if own.exists() or shared == own else shared)


def _listed(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """A per-layer metric with ``workloads`` is read in those cells; one
    without, in every cell that reports the metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(bench: dict, workload: str, root: Path = HERE) -> Cell:
    """The cell named ``workload`` of the benchmark ``bench``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the benchmark has "
                       f"{sorted(cells)}")
    w = cells[workload]
    config = json.loads((root / "configs" / f"{w['config']}.json").read_text())
    config["name"] = w["config"]
    traffic = json.loads((root / "traffic"
                          / f"{w['traffic']}.json").read_text())
    driver = load_module(root / "drivers" / f"{traffic['driver']}.py")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if _listed(m, workload, names)]
    return Cell(workload, config, traffic, driver, e2e, layer, root)


@dataclass
class Window:
    """What a measured window did."""

    latencies: List[float] = field(default_factory=list)
    seconds: float = 0.0
    failed: int = 0
    errors: List[str] = field(default_factory=list)
    samples: List[Tuple[int, object]] = field(default_factory=list)
    spans: Dict[str, Tuple[int, float]] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)

    @property
    def calls(self) -> int:
        return len(self.latencies)


def measure(call: Callable[[int], object], sync: Callable[[], None],
            seconds: float, keep: int, seed: int, first: int = 0) -> Window:
    """Calls ``call(first)``, ``call(first + 1)``, ... each closed by
    ``sync()``, until ``seconds`` have passed; a uniform sample of
    ``keep`` outputs drawn from ``seed`` (reservoir), and the last, are
    kept for the check."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 7])
    w = Window()
    reservoir: List[Tuple[int, object]] = []
    last: Optional[Tuple[int, object]] = None
    i = first
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        t0 = time.perf_counter()
        try:
            out = call(i)
            sync()
        except Exception as e:  # a call that fails is counted, not fatal
            w.failed += 1
            if len(w.errors) < 3:
                w.errors.append(f"call {i}: {type(e).__name__}: {e}")
            out = None
        t1 = time.perf_counter()
        w.latencies.append(t1 - t0)
        n = i - first
        if n < keep:
            reservoir.append((i, out))
        else:
            j = int(rng.integers(0, n + 1))
            if j < keep:
                reservoir[j] = (i, out)
        last = (i, out)
        del out
        i += 1
        if t1 >= deadline:
            break
    w.seconds = t1 - t_start
    w.samples = reservoir + ([last] if last[0] not in
                             {k for k, _ in reservoir} else [])
    return w


def snapshot(metrics) -> Tuple[Dict[str, Tuple[int, float]], Dict[str, int]]:
    """The program's metrics collector: stages and counters, copied."""
    return ({k: (s.calls, s.total_s) for k, s in metrics.stages.items()},
            dict(metrics.counters))


def delta(before, after) -> Tuple[Dict[str, Tuple[int, float]],
                                  Dict[str, int]]:
    """What a window added to the collector."""
    (s0, c0), (s1, c1) = before, after
    spans = {k: (v[0] - s0.get(k, (0, 0.0))[0], v[1] - s0.get(k, (0, 0.0))[1])
             for k, v in s1.items()}
    counters = {k: v - c0.get(k, 0) for k, v in c1.items()}
    return spans, counters


def p95_and_count(latencies: List[float]) -> Tuple[float, int, int]:
    """(p95 seconds, calls, calls beyond it)."""
    n = len(latencies)
    return (stats.percentile(latencies, TAIL_PCT), n,
            stats.beyond(n, TAIL_PCT))
