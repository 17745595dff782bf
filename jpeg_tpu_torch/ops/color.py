"""Color space conversions over ``[..., C]`` pixel tensors.

Reference semantics (frame.c:154-244): the C source writes the BT.601
coefficients as double literals, so multiplies/adds involving them happen
in double precision, BUT sub-expressions between float lvalues stay in
float32:

  decode   (Cb - shift), (Cr - shift)        -> float32 subtraction
           Y + 1.402 * (...)                 -> double, stored to float32
  YCCK     R = K - (C * K) / denom           -> entirely float32
  encode   0.299 * R + ... (+ shift)         -> entirely double, stored f32

``exact=True`` reproduces this mixed-precision order bit for bit, one
eager op per product and sum (the plain version of the exact colour
kernel, ``models/dense_exact.py``); ``exact=False`` keeps everything
float32 and differs by at most ~1 ulp.  Both are the JAX package's
``ops/color.py`` forms of the same names.

Grayscale (C=1) passes through untouched, like the reference ``case 1``.
"""

from __future__ import annotations

import torch


def _work_dtype(exact: bool) -> torch.dtype:
    return torch.float64 if exact else torch.float32


def rgb_to_ycc(pixels: torch.Tensor, precision: int,
               exact: bool = False) -> torch.Tensor:
    """RGB -> YCbCr (frame.c:154-186) over a [..., 3] tensor -> float32,
    in the order the C expression is written."""
    x = pixels.to(torch.float32)
    if x.shape[-1] == 1:
        return x
    dt = _work_dtype(exact)
    shift = float(1 << (precision - 1))
    r, g, b = (x[..., i].to(dt) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.1687 * r - 0.3313 * g + 0.5 * b + shift
    cr = 0.5 * r - 0.4187 * g - 0.0813 * b + shift
    return torch.stack([y.to(torch.float32), cb.to(torch.float32),
                        cr.to(torch.float32)], dim=-1)


def _centered_f32(chan: torch.Tensor, precision: int) -> torch.Tensor:
    """float32 ``chan - (1 << (P-1))`` as the C sub-expression computes it."""
    return chan.to(torch.float32) - float(1 << (precision - 1))


def ycc_to_rgb_planar(y, cb, cr, precision: int, exact: bool = False):
    """Planar YCbCr -> (r, g, b) float32 planes (frame.c:219-235)."""
    dt = _work_dtype(exact)
    yv = y.to(torch.float32).to(dt)
    cbv = _centered_f32(cb, precision).to(dt)
    crv = _centered_f32(cr, precision).to(dt)
    r = yv + 1.402 * crv
    g = yv - 0.34414 * cbv - 0.71414 * crv
    b = yv + 1.772 * cbv
    return r.to(torch.float32), g.to(torch.float32), b.to(torch.float32)


def ycc_to_rgb(pixels: torch.Tensor, precision: int,
               exact: bool = False) -> torch.Tensor:
    """YCbCr -> RGB over a [..., 3] tensor."""
    if pixels.shape[-1] == 1:
        return pixels
    r, g, b = ycc_to_rgb_planar(
        pixels[..., 0], pixels[..., 1], pixels[..., 2], precision, exact
    )
    return torch.stack([r, g, b], dim=-1)


def ycck_to_rgb(pixels: torch.Tensor, precision: int,
                exact: bool = False) -> torch.Tensor:
    """YCCK (Adobe 4-component) -> RGB via CMYK inversion (frame.c:196-218).

    The intermediate C/M/Y values are stored to float32; the final
    ``K - (C*K)/denom`` inversion is pure float32 in the reference.
    Returns [..., 4] with the K channel set to 255."""
    denom = float(1 << precision)
    c, m, yy = ycc_to_rgb_planar(
        pixels[..., 0], pixels[..., 1], pixels[..., 2], precision, exact
    )
    k = pixels[..., 3].to(torch.float32)
    r = k - (c * k) / denom
    g = k - (m * k) / denom
    b = k - (yy * k) / denom
    return torch.stack([r, g, b, torch.full_like(r, 255.0)], dim=-1)


def to_rgb(pixels: torch.Tensor, precision: int,
           exact: bool = False) -> torch.Tensor:
    """Dispatch on component count like frame_to_rgb (frame.c:188-244)."""
    n = pixels.shape[-1]
    if n == 4:
        return ycck_to_rgb(pixels, precision, exact)
    if n == 3:
        return ycc_to_rgb(pixels, precision, exact)
    if n == 1:
        return pixels
    raise ValueError(f"unsupported component count {n}")
