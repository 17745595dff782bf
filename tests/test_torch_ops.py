"""PyTorch port: ``ops/zigzag.py`` vs ``jpeg_tpu.ops.zigzag`` (CPU).

Both permutations, as index gathers over the last axis of a ``[..., 64]``
tensor, equal the JAX package's on seeded arrays of several leading
shapes and types, and undo each other.
"""

import numpy as np
import pytest
import torch

from jpeg_tpu.ops import zigzag as jax_zigzag

from jpeg_tpu_torch.ops import zigzag


@pytest.mark.parametrize("shape,dtype", [
    ((64,), np.int32),
    ((5, 64), np.int32),
    ((2, 3, 64), np.float32),
    ((0, 64), np.int32),
], ids=["one", "rows", "batch-float", "empty"])
@pytest.mark.parametrize("name", ["zigzag_to_raster", "raster_to_zigzag"])
def test_zigzag_matches_jpeg_tpu(name, shape, dtype):
    rng = np.random.default_rng(len(shape) * 64 + len(name))
    a = rng.integers(-2048, 2048, shape).astype(dtype)
    got = getattr(zigzag, name)(torch.from_numpy(a))
    want = np.asarray(getattr(jax_zigzag, name)(a))
    assert got.dtype == torch.from_numpy(a).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    other = ("raster_to_zigzag" if name == "zigzag_to_raster"
             else "zigzag_to_raster")
    np.testing.assert_array_equal(getattr(zigzag, other)(got).numpy(), a)
