"""encode_p95_ms: the nearest-rank 95th percentile of the host-clock
latency of every encode call in the window, from the call until its
device synchronize."""

from perfbench import stats


def read(run):
    if run.kind != "encode":
        return None
    return stats.percentile(run.window.latencies, 95.0) * 1e3
