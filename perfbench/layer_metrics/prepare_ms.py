"""prepare_ms.* (``prepare_ms.decode``, ``.live``): the ``device_decode.prepare`` span (the host prep
of each chunk and its uploads), ms a frame."""

from perfbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "device_decode.prepare")
