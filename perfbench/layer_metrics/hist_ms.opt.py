"""hist_ms.opt: the ``device_encode.frame_hist`` span (the per-frame
histogram kernel enqueued and the histograms' one read, which waits for
the dense stage and the kernel), ms a frame.  Reads nothing where the
span never opened (a program without per-frame tables)."""

from perfbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "device_encode.frame_hist")
