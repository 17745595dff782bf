"""Float helpers that replicate C libm semantics bit-for-bit."""

from __future__ import annotations

import torch


def roundf(x: torch.Tensor) -> torch.Tensor:
    """C99 ``roundf``: round to nearest, ties AWAY from zero.

    ``torch.round`` rounds ties to even, which diverges from the
    reference's PNM writer (frame.c:375/385) on exact .5 values, so we
    emulate via trunc + exact fraction comparison.  ``x - trunc(x)`` is
    exact in float (Sterbenz), and values >= 2**23 are already integral,
    so this matches roundf for every float32 input.
    """
    t = torch.trunc(x)
    frac = x - t
    bump = torch.where(x >= 0, 1.0, -1.0).to(x.dtype)
    return torch.where(frac.abs() >= 0.5, t + bump, t)
