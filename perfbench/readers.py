"""Arithmetic the metric readers share, frozen with the benchmark.

Host figures are milliseconds a frame over the measured window of a
``--trace 1`` run, from the program's metrics collector (spans opened by
``jpeg_tpu_torch.utils.metrics.trace``) snapshotted around the window.
Device figures come from the profiled windows that held all their
events (``trace.py``); with none kept, they read nothing.
"""

from __future__ import annotations

from typing import Optional

from . import roofline


def frames(run) -> int:
    return (run.window.calls - run.window.failed) * run.frames_per_call


def span_ms_per_frame(run, *names: str) -> Optional[float]:
    """The spans' time in the window, ms a frame; None if none opened."""
    got = [run.window.spans[n] for n in names if n in run.window.spans]
    if not got or not any(c for c, _ in got) or not frames(run):
        return None
    return sum(s for _, s in got) * 1e3 / frames(run)


def host_other_ms_per_frame(run, *names: str) -> Optional[float]:
    """The calls' host-clock time outside the spans, ms a frame."""
    inside = span_ms_per_frame(run, *names)
    if inside is None:
        return None
    return sum(run.window.latencies) * 1e3 / frames(run) - inside


def roofline_pct(run) -> Optional[float]:
    """The work's byte bound over the kernels' device time, percent."""
    if not run.profiled:
        return None
    bound = sum(roofline.bound_s(r, w) for win in run.profiled
                for r, w in win.work)
    device = sum(win.kernel_us for win in run.profiled) / 1e6
    return roofline.share_pct(bound, device)


def idle_pct(run) -> Optional[float]:
    """Share of the profiled windows in which the device ran nothing."""
    if not run.profiled:
        return None
    busy = sum(w.busy_us for w in run.profiled)
    span = sum(w.window_us for w in run.profiled)
    return 100.0 * (1.0 - busy / span) if span > 0 else None
