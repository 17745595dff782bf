"""The exact mode's dense kernels: bit-identical to the reference codec.

Three entry points, the port of the JAX package's exact dense ops
(``exact=True``, its default): ``idct_exact`` (dequantize -> ordered
float32 IDCT -> level shift, ``jpeg_tpu/ops/dct.py::idct8x8_exact``),
``fdct_exact`` (level unshift -> ordered FDCT -> quantize,
``fdct8x8_exact`` + ``ops/quant.quantize``) and ``color_exact`` (the
mixed float32/float64 colour conversions of ``jpeg_tpu/ops/color.py``
with ``exact=True``).  On a CUDA tensor each launches its kernel of
``csrc/dense_exact.cu`` and counts the launch in ``<wrapper>.launches``;
on a CPU tensor it runs its plain version (``*_ref``), eager PyTorch op
by op as the JAX package runs its exact mode; anything else raises.  The
contract is bitwise equality between kernel and plain version.
"""

from __future__ import annotations

import torch

from ..device import check_tensor, cuda_stream
from ..ops.color import rgb_to_ycc, to_rgb
from ..ops.dct import dct_lut_f32, fdct8x8_exact, idct8x8_exact
from ..ops.quant import dequantize, quantize

# csrc/dense_exact.cu colour modes by (mode, channels)
COLOR_CODES = {("to_rgb", 3): 0, ("to_rgb", 4): 1, ("to_ycc", 3): 2}
F32 = (torch.float32,)
I32 = (torch.int32,)


def idct_exact_ref(coeffs: torch.Tensor, qtable: torch.Tensor,
                   precision: int) -> torch.Tensor:
    """[N, 64] int32 raster coefficients -> [N, 64] float32 samples
    (dequantize, IDCT, + 2^(P-1)), eager ops as the JAX exact path."""
    flt = dequantize(coeffs, qtable)
    out = idct8x8_exact(flt.reshape(-1, 8, 8)) + float(1 << (precision - 1))
    return out.reshape(-1, 64)


def fdct_exact_ref(blocks: torch.Tensor, qtable: torch.Tensor,
                   precision: int) -> torch.Tensor:
    """[N, 64] float32 raster samples -> [N, 64] int32 quantized
    coefficients (- 2^(P-1), FDCT, roundf(c / Q))."""
    x = blocks.to(torch.float32).reshape(-1, 8, 8) - float(
        1 << (precision - 1))
    return quantize(fdct8x8_exact(x).reshape(-1, 64), qtable)


def color_exact_ref(pixels: torch.Tensor, precision: int,
                    mode: str) -> torch.Tensor:
    """[..., C] float32 -> [..., C] float32: ``to_rgb`` (YCbCr or YCCK ->
    RGB) or ``to_ycc`` (RGB -> YCbCr), exact forms."""
    if mode == "to_ycc":
        return rgb_to_ycc(pixels, precision, exact=True)
    return to_rgb(pixels, precision, exact=True)


def _cuda(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


def idct_exact(coeffs: torch.Tensor, qtable: torch.Tensor,
               precision: int) -> torch.Tensor:
    """Exact inverse DCT of [N, 64] int32 blocks -> [N, 64] float32."""
    if coeffs.device.type == "cpu":
        return idct_exact_ref(coeffs, qtable, precision)
    dev = _cuda(coeffs, "idct_exact")
    n = int(coeffs.shape[0])
    check_tensor("coeffs", coeffs, I32, (n, 64), dev)
    check_tensor("qtable", qtable, I32, (64,), dev)

    from ..kernels import load_library

    out = torch.empty(n, 64, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        # The LUT goes to the kernel by value, from its host copy.
        rc = load_library().lib.jt_idct_exact(
            coeffs.data_ptr(), qtable.data_ptr(), dct_lut_f32().ctypes.data,
            out.data_ptr(), n, precision, cuda_stream(dev))
    if rc != 0:
        raise RuntimeError(f"idct_exact launch failed: CUDA error {rc}")
    idct_exact.launches += 1
    return out


idct_exact.launches = 0


def fdct_exact(blocks: torch.Tensor, qtable: torch.Tensor,
               precision: int) -> torch.Tensor:
    """Exact forward DCT + quantizer of [N, 64] float32 blocks -> int32."""
    if blocks.device.type == "cpu":
        return fdct_exact_ref(blocks, qtable, precision)
    dev = _cuda(blocks, "fdct_exact")
    n = int(blocks.shape[0])
    check_tensor("blocks", blocks, F32, (n, 64), dev)
    check_tensor("qtable", qtable, I32, (64,), dev)

    from ..kernels import load_library

    out = torch.empty(n, 64, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        # The LUT goes to the kernel by value, from its host copy.
        rc = load_library().lib.jt_fdct_exact(
            blocks.data_ptr(), qtable.data_ptr(), dct_lut_f32().ctypes.data,
            out.data_ptr(), n, precision, cuda_stream(dev))
    if rc != 0:
        raise RuntimeError(f"fdct_exact launch failed: CUDA error {rc}")
    fdct_exact.launches += 1
    return out


fdct_exact.launches = 0


def color_exact(pixels: torch.Tensor, precision: int,
                mode: str) -> torch.Tensor:
    """Exact colour conversion of [..., C] float32 pixels: ``mode``
    "to_rgb" takes C = 3 (YCbCr) or 4 (YCCK, K comes back as 255),
    "to_ycc" takes C = 3 (RGB).  One channel passes through untouched."""
    if mode not in ("to_rgb", "to_ycc"):
        raise ValueError(f"color_exact: unknown mode {mode!r}")
    c = int(pixels.shape[-1])
    if pixels.device.type == "cpu" or c == 1:
        return color_exact_ref(pixels, precision, mode)
    dev = _cuda(pixels, "color_exact")
    code = COLOR_CODES.get((mode, c))
    if code is None:
        raise ValueError(f"color_exact {mode}: unsupported component count "
                         f"{c}")
    check_tensor("pixels", pixels, F32, pixels.shape, dev)

    from ..kernels import load_library

    out = torch.empty_like(pixels)
    with torch.cuda.device(dev):
        rc = load_library().lib.jt_color_exact(
            pixels.data_ptr(), out.data_ptr(), pixels.numel() // c, code,
            precision, cuda_stream(dev))
    if rc != 0:
        raise RuntimeError(f"color_exact launch failed: CUDA error {rc}")
    color_exact.launches += 1
    return out


color_exact.launches = 0
