"""PyTorch port: the Motion-JPEG slice end to end vs jpeg_tpu (CPU).

The port's ``DeviceDecoder(..., device="cpu").decode_batch`` and
``mjpeg.decode_stream_device`` against ``jpeg_tpu.DeviceDecoder`` with
the Pallas region placement forced on (interpret mode off-TPU), as
``tests/test_place_pallas.py`` runs it: pixels within +-1 (the float32
IDCT matmul sums in another order), coefficients exact.
"""

import numpy as np
import pytest

import jpeg_tpu
from jpeg_tpu.encoder import EncodeParams, encode_jpeg

import jpeg_tpu_torch as jt
from jpeg_tpu_torch.entropy import place_cuda
from refbin import make_ppm

PARAMS = EncodeParams(h=2, v=2, quality=80, restart_interval=2,
                      optimize=False, exact=False)


@pytest.fixture(scope="module")
def frames():
    return [encode_jpeg(make_ppm(64, 48, seed=40 + i), PARAMS)
            for i in range(5)]


@pytest.fixture(scope="module")
def jax_pixels(frames):
    """jpeg_tpu's pixels for the 5 frames, chunk 2 (ragged: 2+2+1)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("JPEG_TPU_PLACE", "pallas")
    try:
        dec = jpeg_tpu.DeviceDecoder.for_stream(frames[0])
        assert dec.place_ri == 2
        return np.asarray(dec.decode_batch(frames, chunk=2))
    finally:
        mp.undo()


def test_decode_batch_ragged_chunks_match_jax(frames, jax_pixels):
    dec = jt.DeviceDecoder.for_stream(frames[0], device="cpu")
    got = dec.decode_batch(frames, chunk=2)
    assert got.device.type == "cpu" and tuple(got.shape) == (5, 48, 64, 3)
    got = got.numpy()
    assert got.dtype == jax_pixels.dtype == np.uint8
    assert np.abs(got.astype(int) - jax_pixels.astype(int)).max() <= 1
    # chunking changes nothing
    np.testing.assert_array_equal(dec.decode_batch(frames, chunk=8).numpy(),
                                  got)
    assert place_cuda.decode_segments.launches == 0


def test_decode_stream_device_matches_jax(frames, jax_pixels, monkeypatch):
    monkeypatch.setenv("JPEG_TPU_PLACE", "pallas")
    stream = b"".join(frames)
    got = jt.mjpeg.decode_stream_device(stream, "cpu", chunk=2).numpy()
    ref = np.asarray(jpeg_tpu.mjpeg.decode_stream_device(stream, chunk=2))
    assert got.shape == ref.shape == (5, 48, 64, 3)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert np.abs(got.astype(int) - jax_pixels.astype(int)).max() <= 1


def test_decode_coeffs_batch_matches_jpeg_tpu(frames):
    dec = jt.DeviceDecoder.for_stream(frames[0], device="cpu")
    got = dec.decode_coeffs_batch(frames, chunk=2).numpy()
    for i, f in enumerate(frames):
        cs, planes = jpeg_tpu.decode_coefficients(f)
        want = np.concatenate([
            np.asarray(planes[c.cid], np.int32).reshape(-1, 64)
            for c in cs.geometry.components])
        np.testing.assert_array_equal(got[i], want)


def test_mixed_tables_raise(frames):
    """The coefficient path raises on frames the stream's plan does not
    take; the pixel path decodes a mixed-table chunk frame by frame
    instead, and raises only when the sizes differ."""
    other = encode_jpeg(make_ppm(64, 48, seed=99),
                        EncodeParams(h=2, v=2, quality=80, restart_interval=2,
                                     optimize=True, exact=False))
    dec = jt.DeviceDecoder.for_stream(frames[0], device="cpu")
    with pytest.raises(jt.UnsupportedError, match="Huffman"):
        dec.decode_coeffs_batch([frames[0], other])
    px = dec.decode_batch([frames[0], other]).numpy().astype(int)
    for got, f in zip(px, (frames[0], other)):
        want = jpeg_tpu.decode_jpeg(f, exact=False).pixels()
        assert np.abs(got - want).max() <= 1
    other_geom = encode_jpeg(make_ppm(64, 32, seed=1), PARAMS)
    with pytest.raises(jt.UnsupportedError, match="geometry"):
        dec.decode_coeffs_batch([frames[0], other_geom])
    with pytest.raises(jt.UnsupportedError, match="size"):
        dec.decode_batch([frames[0], other_geom])
