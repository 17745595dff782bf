"""prepare_ms.rstless: the speculative engine's host prep, the
``device_decode.spec_parse`` spans (each frame's parse and unstuff) and
the ``device_decode.spec_prepare`` spans (word packing, the chunk rows,
their uploads), ms a frame.  Reads nothing where the program opens
neither span."""

from perfbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "device_decode.spec_parse",
                                     "device_decode.spec_prepare")
