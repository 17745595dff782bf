"""8x8 DCT-II/DCT-III, batched over ``[..., 8, 8]`` or flattened blocks.

Three forms, as in the JAX package's ``ops/dct.py``:

* ``idct8x8_exact`` / ``fdct8x8_exact`` -- separable 1-D passes with the
  summation unrolled in ascending-tap order, all in float32, one eager
  op per multiply and add, so each rounds like the reference's ``s +=
  in[u] * lut[x][u]`` loop (imgproc.c:84-170, strict IEEE, no FMA):
  bit-identical to it.  The plain versions of the exact kernels
  (``models/dense_exact.py``).
* ``idct8x8_matmul`` / ``fdct8x8_matmul`` -- ``A @ X @ A^T`` (and
  ``A^T X A``) as two batched 8x8 products, the single-image fast path.
* ``idct8x8_kron`` / ``fdct8x8_kron`` -- one ``[N, 64] @ [64, 64]``
  product with a Kronecker operator, the batched fast path.

The fast forms run in float32 with TF32 off (``device.py``), the
counterpart of the JAX package's ``precision="highest"``; they sum in
another order than the reference, within ~1e-4.

The cosine LUT reproduces the reference's float path exactly
(imgproc.c:84-102): the angle is computed in double, rounded to float32,
and the correctly-rounded cosine of that float32 is taken.
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


def _contract_last_exact(x: torch.Tensor, mat: np.ndarray) -> torch.Tensor:
    """out[..., i] = sum_k x[..., k] * mat[i, k], ascending k, float32,
    every product and sum its own eager op (no FMA contraction)."""
    cols = []
    for i in range(8):
        s = x[..., 0] * float(mat[i, 0])
        for k in range(1, 8):
            s = s + x[..., k] * float(mat[i, k])
        cols.append(s)
    return torch.stack(cols, dim=-1)


def idct8x8_exact(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse DCT, rows then columns (imgproc.c:130-149), float32
    bit-exact."""
    a = dct_lut_f32()
    blocks = blocks.to(torch.float32)
    rows = _contract_last_exact(blocks, a)
    cols = _contract_last_exact(rows.transpose(-1, -2), a)
    return cols.transpose(-1, -2)


def fdct8x8_exact(blocks: torch.Tensor) -> torch.Tensor:
    """Forward DCT, rows then columns (imgproc.c:151-170), float32
    bit-exact."""
    at = np.ascontiguousarray(dct_lut_f32().T)
    blocks = blocks.to(torch.float32)
    rows = _contract_last_exact(blocks, at)
    cols = _contract_last_exact(rows.transpose(-1, -2), at)
    return cols.transpose(-1, -2)


@lru_cache(maxsize=8)
def lut_on(device: torch.device) -> torch.Tensor:
    """``dct_lut_f32()`` as a float32 [8, 8] tensor on ``device``."""
    return torch.from_numpy(dct_lut_f32().copy()).to(device)


def idct8x8_matmul(blocks: torch.Tensor) -> torch.Tensor:
    """Fast form on [..., 8, 8] blocks: IDCT2(X) = A @ X @ A^T."""
    a = lut_on(blocks.device)
    return a @ blocks.to(torch.float32) @ a.T


def fdct8x8_matmul(blocks: torch.Tensor) -> torch.Tensor:
    """Fast form on [..., 8, 8] blocks: FDCT2(X) = A^T @ X @ A."""
    a = lut_on(blocks.device)
    return a.T @ blocks.to(torch.float32) @ a


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
