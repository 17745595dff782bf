"""split_ms.* (``split_ms.decode``, ``.rstless``): the
``device_decode.split`` span (``mjpeg.split_stream`` cutting a call's
stream into frames), ms a frame.  Reads nothing where the program opens
no such span."""

from perfbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "device_decode.split")
