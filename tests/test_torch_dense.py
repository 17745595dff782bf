"""PyTorch port: dense decode tail vs jpeg_tpu (CPU).

The port's ``_dense_from_coeffs`` (dequant -> Kronecker IDCT matmul ->
upsample -> colour -> round/clip) against the JAX package's
``device_decode._dense_only`` on the same coefficients: within +-1 per
u8/u16 sample, because the float32 matmul sums in another order.  The
elementwise ops it is built from are pinned one by one.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jpeg_tpu
from jpeg_tpu import mjpeg as jmjpeg
from jpeg_tpu.format.parse import parse_codestream as jax_parse
from jpeg_tpu.models.device_decode import _dense_only
from jpeg_tpu.ops import color as jcolor
from jpeg_tpu.ops import dct as jdct
from jpeg_tpu.ops.resample import upsample_nn as j_upsample
from jpeg_tpu.utils.floatops import roundf as j_roundf

from jpeg_tpu_torch.device import set_precision
from jpeg_tpu_torch.format.parse import parse_codestream
from jpeg_tpu_torch.models.device_decode import _dense_from_coeffs
from jpeg_tpu_torch.ops import color, dct
from jpeg_tpu_torch.ops.resample import upsample_nn
from jpeg_tpu_torch.utils.floatops import roundf

CORPUS = Path(__file__).resolve().parent / "data" / "torch_port"


def _coeffs(frames):
    """[F, total_blocks, 64] int32 from jpeg_tpu.decode_coefficients."""
    out = []
    for f in frames:
        cs, planes = jpeg_tpu.decode_coefficients(f)
        out.append(np.concatenate([
            np.asarray(planes[c.cid], np.int32).reshape(-1, 64)
            for c in cs.geometry.components]))
    return np.stack(out)


@pytest.mark.parametrize("name,noise", [
    ("yuv420_ri2", False),
    ("yuv420_ri2", True),  # large coefficients: clipping at both ends
    ("yuv444_ri3", False),
    ("gray_ri4", False),
    ("p12_422_ri2", False),  # 12-bit: uint16 samples
])
def test_dense_tail_matches_jax(name, noise):
    set_precision()
    frames = jmjpeg.split_stream((CORPUS / f"{name}.mjpeg").read_bytes())
    coeffs = _coeffs(frames)
    if noise:
        rng = np.random.default_rng(5)
        coeffs = coeffs + rng.integers(-40, 41, coeffs.shape, dtype=np.int32)
    jcs = jax_parse(frames[0])
    pcs = parse_codestream(frames[0])
    qt = pcs.qtables.astype(np.int32)
    ref = np.asarray(_dense_only(jcs.geometry, jnp.asarray(coeffs),
                                 jnp.asarray(qt)))
    got = _dense_from_coeffs(torch.from_numpy(coeffs), pcs.geometry,
                             torch.from_numpy(qt))
    assert got.is_contiguous()
    assert got.dtype == (torch.uint8 if pcs.geometry.precision <= 8
                         else torch.uint16)
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    diff = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.99
    if noise:
        assert (got == 0).any() and (got == 255).any()


def test_dense_ops_match_jax():
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((3, 16, 24)) * 300).astype(np.float32)
    x[0, 0, :4] = [2.5, -2.5, 0.5, -0.5]  # ties round away from zero
    np.testing.assert_array_equal(roundf(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_roundf(jnp.asarray(x))))
    np.testing.assert_array_equal(
        upsample_nn(torch.from_numpy(x), 2, 3).numpy(),
        np.asarray(j_upsample(jnp.asarray(x), 2, 3)))
    np.testing.assert_array_equal(dct.dct_lut_f32(), jdct.dct_lut_f32())
    flat = (rng.standard_normal((50, 64)) * 100).astype(np.float32)
    # outputs reach ~1e3; float32 sums in another order differ by ~1e-4
    np.testing.assert_allclose(
        dct.idct8x8_kron(torch.from_numpy(flat)).numpy(),
        np.asarray(jdct.idct8x8_kron(jnp.asarray(flat))),
        rtol=0, atol=1e-3)


@pytest.mark.parametrize("nc", [1, 3, 4])
def test_color_matches_jax(nc):
    rng = np.random.default_rng(nc)
    px = rng.uniform(0, 255, (2, 8, 8, nc)).astype(np.float32)
    got = color.to_rgb(torch.from_numpy(px), 8).numpy()
    ref = np.asarray(jcolor.to_rgb(jnp.asarray(px), 8, exact=False))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)  # same float32 op order
    if nc == 3:
        planes = [torch.from_numpy(px[..., i]) for i in range(3)]
        r, g, b = color.ycc_to_rgb_planar(*planes, 8)
        np.testing.assert_array_equal(torch.stack([r, g, b], -1).numpy(),
                                      ref)

