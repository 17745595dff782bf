"""readback_ms.* (``readback_ms.decode``, ``.live``): the
``device_decode.readback`` span (a batch's one host read of its decoded
MCU counts: the host waits there for the chunks' kernels, then copies a
few bytes), ms a frame.  Reads nothing where the program opens no such
span."""

from perfbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "device_decode.readback")
