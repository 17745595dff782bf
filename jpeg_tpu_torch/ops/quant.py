"""Quantization / dequantization over ``[..., 64]`` coefficient tensors.

Reference semantics (imgproc.c:10-30):
  dequantize: flt = float(int32_coeff * int32_Q)   (integer multiply, then
              a single correctly-rounded int->float conversion)
  quantize:   int = int32(roundf(flt / float(Q)))  (f32 divide, roundf)
"""

from __future__ import annotations

import torch

from ..utils.floatops import roundf


def dequantize(coeffs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """``coeffs`` int32 [..., 64] (raster order), ``qtable`` int [64]."""
    c = coeffs.to(torch.int32)
    q = qtable.to(torch.int32)
    return (c * q).to(torch.float32)


def quantize(coeffs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """``coeffs`` float32 [..., 64] -> int32, roundf(c / Q) per coefficient."""
    c = coeffs.to(torch.float32)
    q = qtable.to(torch.int32).to(torch.float32)
    return roundf(c / q).to(torch.int32)
