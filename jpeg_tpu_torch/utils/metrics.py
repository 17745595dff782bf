"""Observability: structured per-stage timings and counters.

Replaces the reference's printf narration (SURVEY §5: decoder.c:495,
imgproc.c:38, common.c:174 ...) with structured timings and counters a
production service can export.

A span (``with trace(name):``) adds its calls and host seconds to
``default_metrics.stages[name]``.  While a ``torch.profiler`` records,
it also opens a ``record_function`` range of its name, so the profiler's
trace shows the program's spans on the device trace's clock; otherwise
it costs two clock reads.  Spans nest on one thread: the spans of one
call are those inside its outermost span (``device_decode.stream``,
``device_decode.batch``, ``device_encode.batch``).  Every span name
starts with ``device_decode.`` or ``device_encode.``.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from time import perf_counter
from typing import Dict

import torch

# Whether a torch.profiler records on this thread (0.1 us a call).
_profiling = torch._C._autograd._profiler_enabled


@dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0


class Metrics:
    """Per-stage wall-clock accumulator and event counters."""

    def __init__(self) -> None:
        self.stages: Dict[str, StageStats] = defaultdict(StageStats)
        self.counters: Dict[str, int] = defaultdict(int)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n


# Global default collector (opt-in use).
default_metrics = Metrics()


class trace:
    """``with trace(name):`` times the block into ``default_metrics``
    and, while a profiler records, mirrors it as a profiler range."""

    __slots__ = ("name", "_t0", "_range")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        self._range = None
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = perf_counter()

    def __exit__(self, *exc) -> None:
        dt = perf_counter() - self._t0
        s = default_metrics.stages[self.name]
        s.calls += 1
        s.total_s += dt
        if self._range is not None:
            self._range.__exit__(*exc)
