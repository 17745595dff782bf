"""host_other_ms.* (``host_other_ms.decode``, ``.live``): the decode calls' host-clock time outside the
program's ``device_decode.prepare`` and ``device_decode.dispatch`` spans
(``split_stream``, ``for_stream``, the batch's MCU read and the wait for
the card), ms a frame."""

from perfbench import readers


def read(run):
    return readers.host_other_ms_per_frame(run, "device_decode.prepare",
                                           "device_decode.dispatch")
