"""dispatch_ms.* (``dispatch_ms.decode``, ``.live``): the ``device_decode.dispatch`` span (the kernels
of each chunk enqueued, the dense tail included), ms a frame."""

from perfbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "device_decode.dispatch")
