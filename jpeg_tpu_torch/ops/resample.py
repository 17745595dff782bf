"""Chroma up/down-sampling (reference frame.c:38-132).

Upsample is nearest-neighbour patch replication with integer steps
(transform_components_to_frame); downsample is a box average over the
step_y x step_x patch (transform_frame_to_components) with the
reference's float32 accumulation order (yy outer, xx inner, from 0.f).
The steps are the integer ratios size/c derived from sampling factors.
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


def downsample_box(plane: torch.Tensor, step_y: int,
                   step_x: int) -> torch.Tensor:
    """[..., h, w] -> [..., h/step_y, w/step_x] box filter, float32,
    in the reference's add order."""
    x = plane.to(torch.float32)
    if step_y == 1 and step_x == 1:
        return x
    h, w = x.shape[-2], x.shape[-1]
    cy, cx = h // step_y, w // step_x
    patches = x.reshape(*x.shape[:-2], cy, step_y, cx, step_x)
    acc = torch.zeros(patches.shape[:-4] + (cy, cx), dtype=torch.float32,
                      device=x.device)
    for yy in range(step_y):
        for xx in range(step_x):
            acc = acc + patches[..., yy, :, xx]
    return acc / float(step_y * step_x)
