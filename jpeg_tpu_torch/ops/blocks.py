"""Block <-> planar raster reshapes (reference imgproc.c:233-293)."""

from __future__ import annotations

import torch


def blocks_to_plane(blocks: torch.Tensor, b_y: int, b_x: int) -> torch.Tensor:
    """[b_y*b_x, 8, 8] blocks (raster block order) -> [b_y*8, b_x*8] plane."""
    x = blocks.reshape(b_y, b_x, 8, 8)
    return x.permute(0, 2, 1, 3).reshape(b_y * 8, b_x * 8)


def plane_to_blocks(plane: torch.Tensor, b_y: int, b_x: int) -> torch.Tensor:
    """[b_y*8, b_x*8] plane -> [b_y*b_x, 8, 8] blocks (raster block order)."""
    x = plane.reshape(b_y, 8, b_x, 8)
    return x.permute(0, 2, 1, 3).reshape(b_y * b_x, 8, 8)
