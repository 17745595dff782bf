"""Observability: structured per-stage metrics and profiler hooks.

Replaces the reference's printf narration (SURVEY §5: decoder.c:495,
imgproc.c:38, common.c:174 ...) with structured timings and counters a
production service can export.  ``trace()`` additionally wraps a region
in a torch.profiler range (Perfetto-compatible) when profiling is enabled.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterator


@dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0
    items: int = 0  # e.g. pixels, blocks, bytes

    @property
    def mean_ms(self) -> float:
        return self.total_s / self.calls * 1e3 if self.calls else 0.0

    def rate(self, unit_scale: float = 1e6) -> float:
        """items per second / unit_scale (e.g. Mpix/s)."""
        return self.items / self.total_s / unit_scale if self.total_s else 0.0


class Metrics:
    """Per-stage wall-clock + throughput accumulator."""

    def __init__(self) -> None:
        self.stages: Dict[str, StageStats] = defaultdict(StageStats)
        self.counters: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            s = self.stages[name]
            s.calls += 1
            s.total_s += time.perf_counter() - t0
            s.items += items

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.stages.items()):
            lines.append(
                f"{name}: {s.calls} calls, {s.mean_ms:.2f} ms avg"
                + (f", {s.rate():.1f} M items/s" if s.items else "")
            )
        for name, v in sorted(self.counters.items()):
            lines.append(f"{name}: {v}")
        return "\n".join(lines)


# Global default collector (opt-in use).
default_metrics = Metrics()


@contextlib.contextmanager
def trace(name: str) -> Iterator[None]:
    """torch.profiler record_function when JPEG_TPU_PROFILE=1, else no-op."""
    if os.environ.get("JPEG_TPU_PROFILE") == "1":
        import torch.profiler

        with torch.profiler.record_function(name):
            with default_metrics.stage(name):
                yield
    else:
        with default_metrics.stage(name):
            yield
