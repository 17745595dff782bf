"""finalize_ms.opt: the ``device_encode.finalize`` span (the native host
tail: padding, byte stuffing, markers and each frame's own header), ms a
frame, in the cell with per-frame tables."""

from perfbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "device_encode.finalize")
