"""Profiled windows: the device's work and idle time, read from
``torch.profiler``.

Each window is one fresh profiler over a few calls of the cell's entry,
with the program's own host spans turned on (``JPEG_TPU_PROFILE=1``).
The profiler on the H100 machine has been seen to drop device events,
and a lost event would read as idle time.  So a window is kept only
where its device events number exactly those of the first profiled call
times its calls (``complete``); any other window is dropped and another
is taken.

Device events are kernels and copies; the ranges that the host's spans
mirror onto the device timeline are not.  ``busy_us`` is the union of
the device events' intervals (a frozen copy of the port's bring-up
check's), kernel time the sum of the kernels' durations (copies
excluded).  Idle gaps are the parts of the window that no device event
covers, each named by the innermost host span open at its midpoint.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

CALL_SPAN = "perfbench.call"
COPY_PREFIXES = ("Memcpy", "Memset")


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def union(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(window: Tuple[float, float],
         intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The parts of ``window`` that no interval covers."""
    lo, hi = window
    out, at = [], lo
    for s, e in union(intervals):
        if e <= lo or s >= hi:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def complete(events: int, first_call_events: int, calls: int) -> bool:
    """Whether a window of ``calls`` calls holds all its device events."""
    return first_call_events > 0 and events == first_call_events * calls


@dataclass
class Window:
    """One profiled window, on the profiler's clock (microseconds)."""

    start_us: float
    end_us: float
    device: List[Tuple[str, float, float]]  # kernels and copies
    spans: List[Tuple[str, float, float]]  # host spans, with CALL_SPAN
    work: List[Tuple[int, int]] = field(default_factory=list)  # per call

    @property
    def window_us(self) -> float:
        return self.end_us - self.start_us

    @property
    def busy_us(self) -> float:
        lo, hi = self.start_us, self.end_us
        return busy_us((max(s, lo), min(e, hi)) for _, s, e in self.device
                       if e > lo and s < hi)

    @property
    def kernel_us(self) -> float:
        return sum(e - s for n, s, e in self.device
                   if not n.startswith(COPY_PREFIXES))

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """(host span open at its midpoint, microseconds) of each gap."""
        out = []
        for a, b in gaps((self.start_us, self.end_us),
                         ((s, e) for _, s, e in self.device)):
            mid = (a + b) / 2
            open_ = [(s, n) for n, s, e in self.spans if s <= mid < e]
            out.append((max(open_)[1] if open_ else "between calls", b - a))
        return out


def read_profile(prof) -> Window:
    """A finished profiler -> its ``Window``."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    host = [e for e in events if e.device_type == DeviceType.CPU]
    ranges = {e.name for e in host if getattr(e, "is_user_annotation", False)
              or e.name == CALL_SPAN or e.name.startswith(
                  ("device_decode.", "device_encode."))}
    device = [(e.name, float(e.time_range.start), float(e.time_range.end))
              for e in events if e.device_type == DeviceType.CUDA
              and e.name not in ranges]
    spans = [(e.name, float(e.time_range.start), float(e.time_range.end))
             for e in host if e.name in ranges]
    marks = [(s, e) for n, s, e in spans if n == CALL_SPAN]
    if not marks:
        raise RuntimeError("the profiled window holds no call")
    return Window(start_us=min(s for s, _ in marks),
                  end_us=max(e for _, e in marks), device=device, spans=spans)


def profile_calls(call: Callable[[int], object], first: int, calls: int,
                  sync: Callable[[], None],
                  work: Callable[[int, object], Tuple[int, int]]) -> Window:
    """Calls ``first`` .. ``first + calls - 1`` under a fresh profiler,
    each in a ``CALL_SPAN`` range and closed by ``sync``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    os.environ["JPEG_TPU_PROFILE"] = "1"
    done = []
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(first, first + calls):
                with record_function(CALL_SPAN):
                    out = call(i)
                    sync()
                done.append(work(i, out))
                del out
    finally:
        os.environ.pop("JPEG_TPU_PROFILE", None)
    win = read_profile(prof)
    win.work = done
    return win


def profiled_windows(call, sync, work, calls: int, want: int,
                     attempts: int, log) -> Tuple[List[Window], int]:
    """One call profiled alone, then windows of ``calls`` calls until
    ``want`` are complete or ``attempts`` were made.  -> (the complete
    windows, the calls made)."""
    first = profile_calls(call, 0, 1, sync, work)
    n1 = len(first.device)
    log(f"profile: first call {n1} device events, "
        f"{first.window_us / 1e3} ms")
    kept, at = [], 1
    for attempt in range(attempts):
        t0 = time.perf_counter()
        win = profile_calls(call, at, calls, sync, work)
        at += calls
        ok = complete(len(win.device), n1, calls)
        log(f"profile: window {attempt} {len(win.device)} device events of "
            f"{n1 * calls} ({'kept' if ok else 'dropped'}), "
            f"{win.window_us / 1e3} ms, busy {win.busy_us / 1e3} ms, "
            f"kernels {win.kernel_us / 1e3} ms, read in "
            f"{time.perf_counter() - t0:.3f} s")
        if ok:
            kept.append(win)
            if len(kept) >= want:
                break
    return kept, at


def breakdown(windows: Sequence[Window], top: int = 10) -> Optional[dict]:
    """The device operations that took the most time and the idle time by
    the host span open during it, in seconds, over ``windows``."""
    if not windows:
        return None
    ops: Dict[str, float] = {}
    idle: Dict[str, float] = {}
    for w in windows:
        for n, s, e in w.device:
            ops[n] = ops.get(n, 0.0) + (e - s) / 1e6
        for n, us in w.idle_gaps():
            idle[n] = idle.get(n, 0.0) + us / 1e6
    order = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    gaps_ = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in order],
            "idle_gaps": [[n, s] for n, s in gaps_]}
