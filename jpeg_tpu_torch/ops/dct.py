"""8x8 DCTs over raster-flattened ``[..., 64]`` blocks (fast path).

The cosine LUT reproduces the reference's float path exactly
(imgproc.c:84-102): the angle is computed in double, rounded to float32,
and the correctly-rounded cosine of that float32 is taken.  The IDCT
(the separable ``A X A^T``) and the FDCT (``A^T X A``) are each one
``[N, 64] @ [64, 64]`` product with a Kronecker operator, in float32
with TF32 off (``device.py``) --
the counterpart of the JAX package's ``precision="highest"`` matmul.
Not bit-identical to the reference's LUT loop (different summation
order) but within ~1e-4.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def dct_lut_f32() -> np.ndarray:
    """A[x, u] = 0.5 * C(u) * cos((2x+1) u pi / 16) in float32.

    Matches the reference LUT (imgproc.c:95-102) bit-for-bit.
    """
    lut = np.zeros((8, 8), dtype=np.float32)
    half = np.float32(0.5)
    c0 = np.float32(1.0) / np.sqrt(np.float32(2.0))
    for x in range(8):
        for u in range(8):
            arg = np.float32((2 * x + 1) * u * math.pi / 16)
            cos = np.float32(np.cos(np.float64(arg)))
            scale = np.float32(half * (c0 if u == 0 else np.float32(1.0)))
            lut[x, u] = np.float32(scale * cos)
    return lut


@lru_cache(maxsize=None)
def _kron_mats():
    """[64, 64] flattened-DCT operators: vec(out) = vec(in) @ M."""
    a = dct_lut_f32().astype(np.float64)
    m_idct = np.kron(a.T, a.T).astype(np.float32)  # in (u,v) -> out (y,x)
    m_fdct = np.kron(a, a).astype(np.float32)  # in (y,x) -> out (u,v)
    return m_idct, m_fdct


def idct8x8_kron(flat: torch.Tensor) -> torch.Tensor:
    """IDCT on raster-flattened float32 [..., 64] blocks via one matmul."""
    m = torch.from_numpy(_kron_mats()[0]).to(flat.device)
    return torch.matmul(flat.to(torch.float32), m)


def fdct8x8_kron(flat: torch.Tensor) -> torch.Tensor:
    """FDCT on raster-flattened float32 [..., 64] blocks via one matmul."""
    m = torch.from_numpy(_kron_mats()[1]).to(flat.device)
    return torch.matmul(flat.to(torch.float32), m)
