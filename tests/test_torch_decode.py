"""PyTorch port: the Motion-JPEG slice end to end vs jpeg_tpu (CPU).

The port's ``DeviceDecoder(..., device="cpu").decode_batch`` and
``mjpeg.decode_stream_device`` against ``jpeg_tpu.DeviceDecoder`` with
the Pallas region placement forced on (interpret mode off-TPU), as
``tests/test_place_pallas.py`` runs it: pixels within +-1 (the float32
IDCT matmul sums in another order), coefficients exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jpeg_tpu
from jpeg_tpu.encoder import EncodeParams, encode_jpeg
from jpeg_tpu.models.device_decode import _dense_only

import jpeg_tpu_torch as jt
from jpeg_tpu_torch.entropy import place_cuda
from jpeg_tpu_torch.format.parse import parse_codestream
from jpeg_tpu_torch.utils.metrics import default_metrics
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


@pytest.fixture(scope="module")
def mixed_quality():
    """Four 64x48 frames whose quality changes from frame to frame (q50,
    q95, q50, q75; a camera's rate control): one geometry and the default
    Huffman tables, but each frame its own DQT."""
    return [encode_jpeg(make_ppm(64, 48, seed=60 + i), EncodeParams(
        h=2, v=2, quality=q, restart_interval=2, optimize=False,
        exact=False)) for i, q in enumerate((50, 95, 50, 75))]


def _jax_own_tables(frame, qtables=None):
    """jpeg_tpu's dense tail on the frame's coefficients with the frame's
    own tables (or ``qtables``)."""
    cs, planes = jpeg_tpu.decode_coefficients(frame)
    coeffs = np.concatenate([np.asarray(planes[c.cid], np.int32)
                             .reshape(-1, 64) for c in cs.geometry.components])
    qt = cs.qtables.astype(np.int32) if qtables is None else qtables
    return np.asarray(_dense_only(cs.geometry, jnp.asarray(coeffs[None]),
                                  jnp.asarray(qt)))[0]


@pytest.mark.parametrize("chunk", [2, 8])
def test_mixed_quality_stream_uses_each_frames_tables(mixed_quality, chunk):
    """Every frame within +-1 of jpeg_tpu's dense tail run with that
    frame's own tables (the float32 IDCTs sum in other orders), on the
    device path: no chunk falls back.  With the first frame's tables,
    frame 1 (q95 under q50's tables) is off by far more."""
    dec = jt.DeviceDecoder.for_stream(mixed_quality[0], device="cpu")
    before = default_metrics.counters.get("device_decode.mixed_fallbacks", 0)
    got = dec.decode_batch(mixed_quality, chunk=chunk).numpy().astype(int)
    assert default_metrics.counters.get("device_decode.mixed_fallbacks",
                                        0) == before
    for i, frame in enumerate(mixed_quality):
        assert np.abs(got[i] - _jax_own_tables(frame)).max() <= 1
    first = parse_codestream(mixed_quality[0]).qtables
    wrong = _jax_own_tables(mixed_quality[1], first.astype(np.int32))
    assert np.abs(got[1] - wrong.astype(int)).max() > 20


def test_prepare_uploads_tables_only_for_a_mixed_chunk(frames,
                                                       mixed_quality):
    dec = jt.DeviceDecoder.for_stream(frames[0], device="cpu")
    _, _, qt = dec.prepare(frames[:3])
    assert tuple(qt.shape) == (3, 4, 64) and qt.stride(0) == 0
    assert qt.data_ptr() == dec.qtables.data_ptr()  # the cached set
    dec = jt.DeviceDecoder.for_stream(mixed_quality[0], device="cpu")
    _, _, qt = dec.prepare(mixed_quality)
    assert tuple(qt.shape) == (4, 4, 64) and qt.is_contiguous()
    want = np.stack([parse_codestream(f).qtables
                     for f in mixed_quality]).astype(np.int32)
    np.testing.assert_array_equal(qt.numpy(), want)
    assert qt.dtype == torch.int32
    assert not np.array_equal(want[0], want[1])
