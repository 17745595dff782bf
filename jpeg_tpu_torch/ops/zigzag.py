"""Zig-zag permutation helpers over ``[..., 64]`` coefficient tensors."""

from __future__ import annotations

import torch

from ..constants import INV_ZIGZAG, ZIGZAG


def zigzag_to_raster(vec: torch.Tensor) -> torch.Tensor:
    """Reorder a zig-zag-ordered [..., 64] tensor into raster order.

    out[raster_pos] = in[zigzag_pos]: a gather with INV_ZIGZAG.
    """
    return vec[..., torch.from_numpy(INV_ZIGZAG).to(vec.device).long()]


def raster_to_zigzag(vec: torch.Tensor) -> torch.Tensor:
    """Reorder a raster-ordered [..., 64] tensor into zig-zag order."""
    return vec[..., torch.from_numpy(ZIGZAG).to(vec.device).long()]
