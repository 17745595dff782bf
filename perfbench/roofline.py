"""Peaks of one NVIDIA H100 and the least time a piece of work needs.

NVIDIA's data sheet for the SXM part gives 3.35 TB/s of HBM3 bandwidth
at the full 700 W.  A codec's work is bound by its bytes: the least time
for a call is its input read once plus its output written once, at that
rate, whichever kernels do it.  A later change that fuses or removes a
kernel leaves the count right.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def bound_s(bytes_read: int, bytes_written: int) -> float:
    """Seconds to move the work's bytes once at the HBM rate."""
    return (bytes_read + bytes_written) / HBM_BYTES_PER_S


def decode_bytes(compressed: int, pixels: int) -> tuple:
    """(read, written) of a decode: the compressed frames in, the RGB
    pixels out, one byte a sample."""
    return compressed, pixels * 3


def encode_bytes(pixels: int, compressed: int) -> tuple:
    """(read, written) of an encode: the RGB pixels in, one byte a
    sample, the JPEG frames out."""
    return pixels * 3, compressed


def share_pct(bound_seconds: float, device_seconds: float):
    """The bound as a percentage of the measured device time, or None
    where there is no device time to compare."""
    if device_seconds <= 0:
        return None
    return 100.0 * bound_seconds / device_seconds
