"""dispatch_ms.rstless: the speculative engine's launches, the
``device_decode.spec_dispatch`` spans (K8-K10 enqueued) and the
``device_decode.spec_dense`` spans (the tables' upload and K3
enqueued), ms a frame.  Reads nothing where the program opens neither
span."""

from perfbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "device_decode.spec_dispatch",
                                     "device_decode.spec_dense")
