"""pull_ms.opt: the ``device_encode.pull`` span (the word count read and
the copies of the words to the host), ms a frame, in the cell with
per-frame tables."""

from perfbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "device_encode.pull")
