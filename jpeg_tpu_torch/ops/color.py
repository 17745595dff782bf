"""Color space conversions, fast (float32) path.

Reference semantics (frame.c:154-244).  The JAX package's ``exact=True``
mode reproduces the reference's mixed f32/f64 arithmetic bit-for-bit;
this port carries only its ``exact=False`` form, which keeps everything
float32 and differs by at most ~1 ulp.

Grayscale (C=1) passes through untouched, like the reference ``case 1``.
"""

from __future__ import annotations

import torch


def rgb_to_ycc(pixels: torch.Tensor, precision: int) -> torch.Tensor:
    """RGB -> YCbCr (frame.c:154-186) over a [..., 3] tensor, float32.

    The JAX package's ``exact=False`` form: every product and sum in
    float32, in the order the C expression is written.
    """
    x = pixels.to(torch.float32)
    if x.shape[-1] == 1:
        return x
    shift = float(1 << (precision - 1))
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.1687 * r - 0.3313 * g + 0.5 * b + shift
    cr = 0.5 * r - 0.4187 * g - 0.0813 * b + shift
    return torch.stack([y, cb, cr], dim=-1)


def _centered_f32(chan: torch.Tensor, precision: int) -> torch.Tensor:
    """float32 ``chan - (1 << (P-1))`` as the C sub-expression computes it."""
    return chan.to(torch.float32) - float(1 << (precision - 1))


def ycc_to_rgb_planar(y, cb, cr, precision: int):
    """Planar YCbCr -> (r, g, b) float32 planes (frame.c:219-235)."""
    yv = y.to(torch.float32)
    cbv = _centered_f32(cb, precision)
    crv = _centered_f32(cr, precision)
    r = yv + 1.402 * crv
    g = yv - 0.34414 * cbv - 0.71414 * crv
    b = yv + 1.772 * cbv
    return r, g, b


def ycc_to_rgb(pixels: torch.Tensor, precision: int) -> torch.Tensor:
    """YCbCr -> RGB over a [..., 3] tensor."""
    r, g, b = ycc_to_rgb_planar(
        pixels[..., 0], pixels[..., 1], pixels[..., 2], precision
    )
    return torch.stack([r, g, b], dim=-1)


def ycck_to_rgb(pixels: torch.Tensor, precision: int) -> torch.Tensor:
    """YCCK (Adobe 4-component) -> RGB via CMYK inversion (frame.c:196-218).
    Returns [..., 4] with the K channel set to 255."""
    denom = float(1 << precision)
    c, m, yy = ycc_to_rgb_planar(
        pixels[..., 0], pixels[..., 1], pixels[..., 2], precision
    )
    k = pixels[..., 3].to(torch.float32)
    r = k - (c * k) / denom
    g = k - (m * k) / denom
    b = k - (yy * k) / denom
    return torch.stack([r, g, b, torch.full_like(r, 255.0)], dim=-1)


def to_rgb(pixels: torch.Tensor, precision: int) -> torch.Tensor:
    """Dispatch on component count like frame_to_rgb (frame.c:188-244)."""
    n = pixels.shape[-1]
    if n == 4:
        return ycck_to_rgb(pixels, precision)
    if n == 3:
        return ycc_to_rgb(pixels, precision)
    if n == 1:
        return pixels
    raise ValueError(f"unsupported component count {n}")
