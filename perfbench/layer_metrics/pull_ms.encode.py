"""pull_ms.encode: the ``device_encode.pull`` span (the word count read
and the copies of the words to the host), ms a frame."""

from perfbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "device_encode.pull")
