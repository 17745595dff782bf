"""PyTorch port: DeviceDecoder's flat-upload prep vs jpeg_tpu's (CPU).

The flat prep mode packs a chunk's restart segments back to back in one
u32 buffer, uploads it and rebuilds the ``[S, wn]`` lane matrix on the
device (``rows_from_flat``, K13 on the card, its plain version here), as
jpeg_tpu's ``_prepare_native`` "flat" mode and ``_decode_device_flat``
do.  Held here:

* the port's flat buffer, starts, bit counts, ``wn`` and sticky buffer
  length equal jpeg_tpu's byte for byte, also on a chunk that grows
  ``wn`` and on a smaller chunk after a larger one;
* ``rows_from_flat_ref`` equals the JAX gather ``jnp.take(buf, starts[:,
  None] + arange(wn), mode="clip")``, rows that clip at both ends included;
* a flat decode equals a rows decode integer for integer (coefficients,
  per-lane MCU counts, pixels) on gray, 4:2:0 and 4:2:2 streams with
  restart intervals 1-4 and one shape the region placement rejects, on
  intact frames and on frames with damaged bytes and with bytes cut out of
  segments (a lane's words past its end are then the next segment's, not
  zeros); the intact frames equal jpeg_tpu's host decode, and the whole
  chunk jpeg_tpu's flat device program (its flat prep, the gather, its
  scan and placement);
* ``for_stream`` takes rows on the CPU and flat on a card, the
  ``prep_mode`` field set later takes effect on the next chunk and any
  other mode raises, "rows" that keep overflowing fall through to flat,
  bad frames and another header go to the Python prep, and the counters
  count the mode that ran.

jpeg_tpu's decoder takes its mode from ``JPEG_TPU_PREP``, which the tests
set for it; the port's from its field.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jpeg_tpu
from jpeg_tpu.encoder import EncodeParams as JParams
from jpeg_tpu.encoder import encode_jpeg as jax_encode
from jpeg_tpu.entropy.lockstep_jax import _scan_lanes, decode_scan_device
from jpeg_tpu.entropy.place_pallas import place_emissions_region
from jpeg_tpu.models.device_decode import DeviceDecoder as JaxDecoder

from jpeg_tpu_torch import native
from jpeg_tpu_torch.entropy import place_cuda
from jpeg_tpu_torch.format.parse import parse_codestream
from jpeg_tpu_torch.models import device_decode as dd
from jpeg_tpu_torch.models.device_decode import DeviceDecoder
from jpeg_tpu_torch.models.flat_rows import rows_from_flat, rows_from_flat_ref
from jpeg_tpu_torch.utils.metrics import default_metrics
import jpeg_tpu_lib
from refbin import make_pgm, make_ppm
from test_torch_host import frames_of
from test_torch_native import _damaged, _truncated

jpeg_tpu_lib.build_once()  # jpeg_tpu's library, whole, before any test

# name -> (gray, width, height, h, v, restart interval); three frames each
STREAMS = {
    "gray_ri1": (True, 48, 40, 1, 1, 1),
    "420_ri2": (False, 64, 48, 2, 2, 2),
    "422_ri3": (False, 96, 32, 2, 1, 3),
    "420_ri4": (False, 128, 48, 2, 2, 4),
    "420_ri3_general": (False, 80, 64, 2, 2, 3),  # 5 MCUs a row
}
FRAMES = 3


@pytest.fixture(scope="module")
def streams():
    out = {}
    for seed, (name, (gray, w, h, hs, vs, ri)) in enumerate(STREAMS.items()):
        params = JParams(h=hs, v=vs, quality=75, restart_interval=ri,
                         optimize=False)
        make = make_pgm if gray else make_ppm
        out[name] = [jax_encode(make(w, h, seed=10 * seed + i), params)
                     for i in range(FRAMES)]
    return out


@pytest.fixture(autouse=True)
def no_env_mode(monkeypatch):
    """jpeg_tpu's decoder in its default mode unless a test sets one."""
    monkeypatch.delenv("JPEG_TPU_PREP", raising=False)


def _counts():
    c = default_metrics.counters
    return tuple(c.get(f"device_decode.{k}_prep_chunks", 0)
                 for k in ("native", "python", "rows", "flat"))


def _delta(before):
    return tuple(b - a for a, b in zip(before, _counts()))


def cut(frame):
    """The second half of every third restart segment cut out, its
    marker kept: those lanes run out of bits mid-symbol."""
    out, prev = bytearray(), 0
    for i, (s, e) in enumerate(parse_codestream(frame).scans[0].ecs_ranges):
        if i % 3 == 1 and e - s > 2:
            m = s + (e - s) // 2
            m -= frame[m - 1] == 0xFF  # keep a stuffed 0xFF 0x00 whole
            out += frame[prev:m]
            prev = e
    return bytes(out + frame[prev:])


@pytest.mark.parametrize("name", list(STREAMS) + ["bench"])
@pytest.mark.parametrize("grow", [False, True], ids=["wn", "grow-wn"])
def test_flat_prep_equals_jpeg_tpu(streams, name, grow, monkeypatch):
    """Buffer, starts, bit counts, wn and blen byte for byte, on a large
    chunk and then a smaller one (the length sticks)."""
    monkeypatch.setenv("JPEG_TPU_PREP", "flat")  # jpeg_tpu's mode
    frames = frames_of(name) if name == "bench" else streams[name]
    big = [frames[i % len(frames)] for i in range(2 * FRAMES)]
    jd = JaxDecoder.for_stream(frames[0])
    pd = DeviceDecoder.for_stream(frames[0], "cpu")
    pd.prep_mode = "flat"
    assert pd.wn == jd.wn
    if grow:
        jd.wn = pd.wn = 4  # every segment of more than 8 bytes widens it
    for chunk in (big, frames[:1]):
        mode, buf, starts, nbits, _ = jd._prepare_native(chunk)
        assert mode == "flat"
        p_buf, p_starts, p_lens, _ = pd._pack_flat(chunk)
        assert p_buf.dtype == buf.dtype == np.uint32
        np.testing.assert_array_equal(p_buf, buf)
        np.testing.assert_array_equal(p_starts, starts)
        np.testing.assert_array_equal(p_lens * 8, nbits)
        assert (pd.wn, pd.flat_blen) == (jd.wn, jd.flat_blen)
        assert pd.wn % 16 == 0 and pd.wn > (4 if grow else 0)
        before = _counts()
        words, nb, qt = pd.prepare(chunk)
        assert _delta(before) == (1, 0, 0, 1)
        assert words.dtype == nb.dtype == torch.int32
        want = rows_from_flat_ref(torch.from_numpy(buf.view(np.int32)),
                                  torch.from_numpy(starts), jd.wn)
        assert torch.equal(words, want)
        np.testing.assert_array_equal(nb.numpy(), nbits)
        assert qt.shape == (len(chunk), 4, 64) and qt.stride(0) == 0
    assert pd.flat_blen >= (131072 if name == "bench" else 65536)


@pytest.mark.parametrize("wn", [16, 20, 5])
def test_rows_from_flat_ref_equals_jax_gather(wn):
    """``_decode_device_flat``'s gather, rows past either end clipped."""
    rng = np.random.default_rng(wn)
    buf = rng.integers(0, 1 << 32, 1000, dtype=np.uint32)
    starts = np.sort(rng.integers(0, 990, 40)).astype(np.int32)
    starts[0], starts[-3:] = -7, (995, 999, 1200)
    idx = jnp.asarray(starts)[:, None] + jnp.arange(wn, dtype=jnp.int32)
    want = np.asarray(jnp.take(jnp.asarray(buf), idx, mode="clip"))
    for fn in (rows_from_flat_ref, rows_from_flat):  # the CPU dispatch
        got = fn(torch.from_numpy(buf.view(np.int32)),
                 torch.from_numpy(starts), wn)
        assert got.dtype == torch.int32 and tuple(got.shape) == (40, wn)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_rows_from_flat_refuses_other_devices():
    buf = torch.empty(64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rows_from_flat(buf, torch.empty(2, dtype=torch.int32, device="meta"),
                       16)


def _jax_flat_program(frames):
    """jpeg_tpu's flat path on ``frames``: its flat prep, the gather of
    ``_decode_device_flat`` and ``_decode_impl``'s scan and placement
    (the region kernel in interpret mode where ``placement_eligible``,
    else the scatter scan) -> (coeffs [F * tb, 64], lane MCU counts)."""
    jd = JaxDecoder.for_stream(frames[0])
    mode, buf, starts, nbits, _ = jd._prepare_native(frames)
    assert mode == "flat"
    idx = jnp.asarray(starts)[:, None] + jnp.arange(jd.wn, dtype=jnp.int32)
    words = jnp.take(jnp.asarray(buf), idx, mode="clip")
    nbits = jnp.asarray(nbits, jnp.int32)
    spf, ri = jd.segs_per_frame, jd.ri
    tb = sum(c.n_blocks for c in jd.geom.components)
    # One static step bound no lane can exceed: a symbol takes a bit.
    steps = 1 << int(32 * jd.wn + 2).bit_length()
    from jpeg_tpu.entropy.place_pallas import placement_eligible

    if placement_eligible(jd.plan, ri, spf):
        counts, (key, val), starved, nsteps = _scan_lanes(jd.plan, words,
                                                          nbits, steps)
        coeffs = place_emissions_region(jd.plan, key, val, nsteps,
                                        len(frames), spf, ri, interpret=True)
    else:
        counts, coeffs, starved = decode_scan_device(
            jd.plan, words, nbits, steps, tb, frames=len(frames),
            segs_per_frame=spf)
    assert not bool(starved)
    return np.asarray(coeffs).reshape(len(frames), tb, 64), np.asarray(counts)


@pytest.mark.parametrize("name", list(STREAMS))
def test_flat_decode_equals_rows_and_jpeg_tpu(streams, name, monkeypatch):
    """Intact, damaged and cut frames in one chunk: flat == rows ==
    jpeg_tpu's flat program, integer for integer; the intact frames ==
    jpeg_tpu's host decode."""
    frames = streams[name]
    chunk = frames + [frames[0], _damaged(frames[1], 1), cut(frames[2])]
    decs = {}
    for mode in ("rows", "flat"):
        decs[mode] = DeviceDecoder.for_stream(frames[0], "cpu")
        decs[mode].prep_mode = mode
    dec = decs["flat"]
    spf, tb = dec.segs_per_frame, dec.total_blocks
    assert place_cuda.region_path(dec.plan, spf, dec.ri, tb) == (
        not name.endswith("general"))
    out = {}
    for mode, d in decs.items():
        before = _counts()
        words, nbits, _ = d.prepare(chunk)
        assert _delta(before) == ((1, 0, 1, 0) if mode == "rows"
                                  else (1, 0, 0, 1))
        coeffs, counts = d.decode_prepared(words, nbits, len(chunk))
        with pytest.warns(RuntimeWarning, match="MCUs"):
            px = d.decode_batch(chunk, chunk=len(chunk))
        with pytest.warns(RuntimeWarning, match="MCUs"):
            batch = d.decode_coeffs_batch(chunk, chunk=len(chunk))
        assert torch.equal(batch, coeffs)
        out[mode] = (words, nbits, coeffs, counts, px)
    words_r, nbits_r, coeffs, counts, px = out["rows"]
    words_f, nbits_f = out["flat"][:2]
    assert torch.equal(nbits_r, nbits_f)
    # Past a lane's words the rows hold zeros, the flat rows the next
    # segment's.
    assert words_f.shape == words_r.shape
    assert not torch.equal(words_f, words_r)
    for i, t in enumerate(out["flat"][2:]):
        assert torch.equal(t, (coeffs, counts, px)[i])
    want = np.tile(np.diff(np.r_[0, np.minimum(
        np.arange(1, spf + 1) * dec.ri, dec.plan.n_mcus)]), len(chunk))
    lanes = counts.numpy()
    np.testing.assert_array_equal(lanes[:FRAMES * spf], want[:FRAMES * spf])
    assert (lanes[FRAMES * spf:] < want[FRAMES * spf:]).any()
    for i, f in enumerate(frames):
        cs, planes = jpeg_tpu.decode_coefficients(f)
        host = np.concatenate([np.asarray(planes[c.cid], np.int32)
                               .reshape(-1, 64) for c in cs.geometry.components])
        np.testing.assert_array_equal(coeffs[i].numpy(), host)
    monkeypatch.setenv("JPEG_TPU_PREP", "flat")
    j_coeffs, j_counts = _jax_flat_program(chunk)
    np.testing.assert_array_equal(coeffs.numpy(), j_coeffs)
    np.testing.assert_array_equal(lanes, j_counts)


@pytest.mark.parametrize("device,mode", [("cpu", "rows"), ("cuda", "flat")])
def test_for_stream_takes_the_device_default(streams, device, mode,
                                              monkeypatch):
    """``default_prep_mode`` of the device, set by ``for_stream``: rows on
    the CPU, flat on a card (here a stand-in: the card's tensors are the
    host arrays, so no card is needed)."""
    frames = streams["420_ri2"]
    dev = torch.device(device)
    assert dd.default_prep_mode(dev) == mode
    if device == "cuda":
        monkeypatch.setattr(dd, "resolve", lambda d: dev)
        monkeypatch.setattr(dd, "_upload", lambda a, d: torch.from_numpy(a))
    dec = DeviceDecoder.for_stream(frames[0], device)
    assert dec.device == dev and dec.prep_mode == mode
    before = _counts()
    dec.prepare(frames)
    assert _delta(before) == ((1, 0, 1, 0) if mode == "rows"
                              else (1, 0, 0, 1))


@pytest.mark.parametrize("mode", ["rows", "flat", "auto", "padded"])
def test_the_field_set_later_takes_effect(streams, mode):
    """A mode set after construction (and after a chunk in the other mode)
    takes the next chunk; "auto" and every other name raise."""
    frames = streams["422_ri3"]
    dec = DeviceDecoder.for_stream(frames[0], "cpu")
    dec.prep_mode = "flat" if mode == "rows" else "rows"
    dec.prepare(frames)
    dec.prep_mode = mode
    if mode not in dd.PREP_MODES:
        with pytest.raises(ValueError, match="prep mode"):
            dec.prepare(frames)
        return
    before = _counts()
    dec.prepare(frames)
    assert _delta(before) == ((1, 0, 1, 0) if mode == "rows"
                              else (1, 0, 0, 1))
    assert dec.prep_mode == mode


def test_rows_overflow_falls_through_to_flat(streams, monkeypatch):
    """Rows that overflow after every widening: the chunk takes the flat
    prep, whose words and decode equal the Python prep's."""
    frames = streams["420_ri4"]
    dec = DeviceDecoder.for_stream(frames[0], "cpu")
    dec.prep_mode = "rows"
    want = dec.decode_coeffs_batch(frames)
    calls = []

    def overflow(*args):
        calls.append(1)
        return -2

    monkeypatch.setattr(native, "prep_ecs_native", overflow)
    wn = dec.wn
    before = _counts()
    got = dec.decode_coeffs_batch(frames)
    assert _delta(before) == (1, 0, 0, 1) and len(calls) == 4
    assert dec.wn > wn and dec.prep_mode == "rows"
    assert torch.equal(got, want)


def test_bad_frames_take_the_python_prep_in_flat_mode(streams):
    """A truncated frame (fewer segments) and a frame whose header
    differs (another quality) go to the Python prep."""
    frames = streams["420_ri2"]
    dec = DeviceDecoder.for_stream(frames[0], "cpu")
    dec.prep_mode = "flat"
    other = jax_encode(make_ppm(64, 48, seed=99), JParams(
        h=2, v=2, quality=50, restart_interval=2, optimize=False))
    for chunk in ([frames[0], _truncated(frames[1])], [frames[0], other]):
        before = _counts()
        words, nbits, qt = dec.prepare(chunk)
        assert _delta(before) == (0, 1, 0, 0)
    np.testing.assert_array_equal(
        qt.numpy()[1], parse_codestream(other).qtables.astype(np.int32))
