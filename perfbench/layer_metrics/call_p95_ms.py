"""call_p95_ms.* (``call_p95_ms.decode``): the nearest-rank 95th
percentile of the host-clock latency of every call in the measured
window of a ``--trace 1`` run, from the call until its device
synchronize, ms.  A cell reports it per layer where that tail spreads
too widely between runs to hold a bound end to end; the rate it moves is
the cell's end-to-end metric."""

from perfbench import stats


def read(run):
    if not run.window.latencies:
        return None
    return stats.percentile(run.window.latencies, 95.0) * 1e3
