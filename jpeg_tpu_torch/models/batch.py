"""Batched (multi-frame) dense decode and encode -- the Motion-JPEG workhorse.

Every tensor carries an explicit leading frame-batch axis; 8x8 blocks
have no cross-block dependence, so the whole stage is a few batched ops.
"""

from __future__ import annotations

import torch

from ..ops.dct import fdct8x8_kron, idct8x8_kron
from ..ops.quant import dequantize, quantize


def decode_blocks_batch(
    coeffs: torch.Tensor,  # int32 [B, b_y*b_x, 64] raster order
    qtable: torch.Tensor,  # [64]
    b_y: int,
    b_x: int,
    precision: int,
) -> torch.Tensor:
    """dequant -> IDCT -> +shift -> float32 [B, b_y*8, b_x*8] planes.

    Dequant feeds the flattened Kronecker-DCT matmul ([B*n, 64] @ [64, 64]).
    """
    flt = dequantize(coeffs, qtable)
    b = flt.shape[0]
    shift = float(1 << (precision - 1))
    blocks = (idct8x8_kron(flt) + shift).reshape(b, b_y, b_x, 8, 8)
    return blocks.permute(0, 1, 3, 2, 4).reshape(b, b_y * 8, b_x * 8)


def encode_plane_batch(
    plane: torch.Tensor,  # float32 [B, b_y*8, b_x*8]
    qtable: torch.Tensor,  # [64]
    precision: int,
) -> torch.Tensor:
    """-shift -> FDCT -> quantize -> int32 [B, b_y*b_x, 64] raster order."""
    b, h, w = plane.shape
    b_y, b_x = h // 8, w // 8
    blocks = plane.reshape(b, b_y, 8, b_x, 8).permute(0, 1, 3, 2, 4)
    blocks = blocks - float(1 << (precision - 1))
    fdct = fdct8x8_kron(blocks.reshape(b, b_y * b_x, 64))
    return quantize(fdct, qtable)
