"""finalize_ms.encode: the ``device_encode.finalize`` span (the NumPy
host tail: padding, byte stuffing, markers), ms a frame."""

from perfbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "device_encode.finalize")
