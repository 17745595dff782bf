"""hist_roofline.opt: the histogram kernel (K7, found by the name
``hist_blocks``) against the least time its work needs, percent.

The work is counted here from the configuration, not from the program's
block layout: each profiled call's quantized coefficients (frames a call
x blocks a frame x 64) read once at 2 bytes each, the fewest whole bytes
that hold a baseline coefficient of 8-bit samples (11 bits), at the HBM
rate (roofline.py).  The time is the kernel's device time in the
profiled windows.  So a narrower layout of the blocks cannot push the
share past 100%.  Reads nothing where no such kernel ran."""

from perfbench import roofline

KERNEL = "hist_blocks"
COEF_BYTES = 2


def read(run):
    if not run.profiled:
        return None
    geom = run.cell.reference.geometry_of(run.cell.config)
    coefs = run.frames_per_call * geom.n_mcus * geom.bpm * 64
    calls = sum(len(w.work) for w in run.profiled)
    device = sum(e - s for w in run.profiled for n, s, e in w.device
                 if KERNEL in n) / 1e6
    return roofline.share_pct(
        roofline.bound_s(calls * coefs * COEF_BYTES, 0), device)
