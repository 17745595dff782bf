"""device_idle.* (``device_idle.decode``, ``.rstless``, ``.live``,
``.encode``):
the share of the profiled windows (host clock of the
profiler, from the first call's start to the last call's synchronize)
in which no kernel or copy ran on the device, percent."""

from perfbench import readers


def read(run):
    return readers.idle_pct(run)
