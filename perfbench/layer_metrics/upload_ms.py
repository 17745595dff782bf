"""upload_ms.* (``upload_ms.decode``, ``.live``, ``.rstless``): the
``device_decode.upload`` spans (every pageable host-to-device copy of
the decode paths, each inside the layer span that makes it), ms a
frame.  Reads nothing where the program opens no such span."""

from perfbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "device_decode.upload")
