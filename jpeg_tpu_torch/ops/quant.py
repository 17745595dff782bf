"""Dequantization over ``[..., 64]`` coefficient tensors.

Reference semantics (imgproc.c:10-30):
  dequantize: flt = float(int32_coeff * int32_Q)   (integer multiply, then
              a single correctly-rounded int->float conversion)
"""

from __future__ import annotations

import torch


def dequantize(coeffs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """``coeffs`` int32 [..., 64] (raster order), ``qtable`` int [64]."""
    c = coeffs.to(torch.int32)
    q = qtable.to(torch.int32)
    return (c * q).to(torch.float32)
