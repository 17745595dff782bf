"""Chroma upsampling (reference frame.c:38-132).

Upsample is nearest-neighbour patch replication with integer steps
(transform_components_to_frame); the steps are the integer ratios
size/c derived from sampling factors.
"""

from __future__ import annotations

import torch


def upsample_nn(plane: torch.Tensor, step_y: int, step_x: int) -> torch.Tensor:
    """[..., h, w] -> [..., h*step_y, w*step_x] by patch replication."""
    x = plane
    if step_y != 1:
        x = torch.repeat_interleave(x, step_y, dim=-2)
    if step_x != 1:
        x = torch.repeat_interleave(x, step_x, dim=-1)
    return x
