"""kernel_roofline.* (``kernel_roofline.decode``, ``.rstless``, ``.live``,
``.encode``): the least time the profiled calls' work needs
(their input read once and output written once at the HBM rate,
roofline.py) over the time the device spent in kernels in the
profiled windows (copies left out), percent."""

from perfbench import readers


def read(run):
    return readers.roofline_pct(run)
