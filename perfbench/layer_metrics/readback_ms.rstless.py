"""readback_ms.rstless: the ``device_decode.spec_readback`` span (the
speculative engine's one host read a batch, after K10: the host waits
there for K8-K10, then copies the frames' checks), ms a frame.  Reads
nothing where the program opens no such span."""

from perfbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "device_decode.spec_readback")
