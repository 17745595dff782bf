"""for_stream_ms.* (``for_stream_ms.decode``, ``.rstless``): the
``device_decode.for_stream`` span (``DeviceDecoder.for_stream`` on a
call's first frame: its parse, the scan plan, the tables' upload), ms a
frame.  Reads nothing where the program opens no such span."""

from perfbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "device_decode.for_stream")
