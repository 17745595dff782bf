"""tables_ms.opt: the ``device_encode.frame_tables`` span (a chunk's
Annex K.2 builds, the code tables' upload and the frames' headers), ms a
frame.  Reads nothing where the span never opened."""

from perfbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "device_encode.frame_tables")
