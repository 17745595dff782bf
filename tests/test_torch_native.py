"""PyTorch port: the native host layer vs jpeg_tpu's (CPU).

``jpeg_tpu_torch/native`` builds its byte-for-byte copy of
``jpeg_tpu/native/scanner.cpp`` with g++ at first use.  Held here:

* entropy: ``decode_coefficients(entropy="native")`` equals jpeg_tpu's
  ``entropy="native"`` integer for integer, MCU counts included, on every
  frame of the committed corpus, intact, truncated mid-scan and with
  bit damage in every third restart segment; and equals the serial
  oracle on the intact and truncated frames.  (On bit-damaged frames
  jpeg_tpu's own native and serial engines stop a damaged segment at
  different points, so there the port's serial engine is held to
  jpeg_tpu's serial engine instead.)  "auto" picks native while the
  library is available, lockstep or serial when it is not, and explicit
  "native" then raises (the cases of ``tests/test_no_native.py``);
* prep: ``DeviceDecoder.prepare`` through ``jt_walk_ecs_rows`` against the
  Python prep on every single-scan corpus stream: words equal over
  ``pack_words``' width and zero past it, bit counts, tables and decoded
  coefficients equal, and the counters name the path; a truncated frame
  and a per-frame DQT take the Python prep; a row too narrow is widened;
  ``prep_ecs_flat_native`` and ``prep_ecs_rows_native`` against
  ``pack_words``; the walk's counters ``native.ecs_walk_frames`` and
  ``native.ecs_walk_refused`` count the frames it packs and refuses;
* encode: ``entropy_backend="native"`` byte-identical to ``"numpy"`` and
  to ``jpeg_tpu.encode_jpeg``, exact and fast, default and optimized
  tables, restart interval 0 and 2; a symbol with no code raises.
"""

import numpy as np
import pytest
import torch

import jpeg_tpu
from jpeg_tpu.encoder import EncodeParams as JParams
from jpeg_tpu.encoder import encode_jpeg as jax_encode

import jpeg_tpu_torch as jt
from jpeg_tpu_torch import native
from jpeg_tpu_torch.entropy import lockstep, serial
from jpeg_tpu_torch.entropy import native as native_entropy
from jpeg_tpu_torch.entropy.lockstep_torch import pack_words
from jpeg_tpu_torch.format.parse import parse_codestream, unstuff_ranges
from jpeg_tpu_torch.models.device_decode import DeviceDecoder, _segment_bytes
from jpeg_tpu_torch.utils.metrics import default_metrics
import jpeg_tpu_lib
from refbin import make_pgm, make_ppm
from test_torch_host import ELIGIBLE, GENERAL, OTHER, frames_of

jpeg_tpu_lib.build_once()  # jpeg_tpu's library, whole, before any test

STREAMS = ELIGIBLE + GENERAL + OTHER
SINGLE_SCAN = ELIGIBLE + GENERAL  # one geometry and tables a stream


@pytest.fixture(scope="module", autouse=True)
def library():
    """Build (or reuse) the port's native library once per module."""
    assert native.available()


def _coeffs(mod, data, entropy):
    cs, planes = mod.decode_coefficients(data, entropy=entropy)
    return cs.mcus_decoded, {c: np.asarray(p) for c, p in planes.items()}


def _assert_equal(a, b, label):
    assert a[0] == b[0], f"{label}: MCU counts {a[0]} vs {b[0]}"
    assert list(a[1]) == list(b[1]), label
    for cid in a[1]:
        np.testing.assert_array_equal(a[1][cid], b[1][cid],
                                      err_msg=f"{label} component {cid}")


def _truncated(frame):
    """The frame cut in the middle of its middle restart segment."""
    ranges = parse_codestream(frame).scans[0].ecs_ranges
    s, e = ranges[len(ranges) // 2]
    return frame[: (s + e) // 2] + b"\xff\xd9"


def _damaged(frame, seed):
    """The frame with one seeded byte in the middle of every third
    restart segment, never next to a 0xFF (no marker is made)."""
    out = bytearray(frame)
    rng = np.random.default_rng(seed)
    for s, e in parse_codestream(frame).scans[0].ecs_ranges[::3]:
        m = (s + e) // 2
        if e - s > 4 and out[m - 1] != 0xFF and out[m] != 0xFF:
            out[m] = int(rng.integers(0, 255))
    return bytes(out)


@pytest.mark.parametrize("name", STREAMS)
def test_native_entropy_matches_serial_and_jpeg_tpu(name):
    frames = frames_of(name)
    # bench: frame 0 (the serial oracle takes seconds a 1080p frame)
    for i, frame in enumerate(frames[:1] if name == "bench" else frames):
        for label, data in ((f"{name}[{i}]", frame),
                            (f"{name}[{i}] truncated", _truncated(frame))):
            got = _coeffs(jt, data, "native")
            _assert_equal(got, _coeffs(jt, data, "serial"), label)
            _assert_equal(got, _coeffs(jpeg_tpu, data, "native"), label)
        data = _damaged(frame, i)
        label = f"{name}[{i}] damaged"
        _assert_equal(_coeffs(jt, data, "native"),
                      _coeffs(jpeg_tpu, data, "native"), label)
        _assert_equal(_coeffs(jt, data, "serial"),
                      _coeffs(jpeg_tpu, data, "serial"), label)


@pytest.mark.parametrize("pnm,kw", [
    (make_pgm(32, 24, seed=61), dict(h=1, v=1, restart_interval=0)),
    (make_ppm(40, 32, seed=62, maxval=4095), dict(h=2, v=1,
                                                  restart_interval=2)),
    (make_ppm(48, 40, seed=60), dict(h=2, v=1, restart_interval=1)),
], ids=["gray", "12-bit 4:2:2", "4:2:2 ri1"])
def test_native_entropy_gray_12bit_422(pnm, kw):
    data = jt.encode_jpeg(pnm, jt.EncodeParams(quality=75, **kw), "cpu")
    got = _coeffs(jt, data, "native")
    _assert_equal(got, _coeffs(jt, data, "serial"), "serial")
    _assert_equal(got, _coeffs(jpeg_tpu, data, "native"), "jpeg_tpu")
    for label, bad in (("truncated", _truncated(data)),
                       ("damaged", _damaged(data, 3))):
        _assert_equal(_coeffs(jt, bad, "native"),
                      _coeffs(jpeg_tpu, bad, "native"), label)


def _record(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def run(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, run)


@pytest.mark.parametrize("ri", [0, 1])
def test_auto_picks_native_while_available(monkeypatch, ri):
    """"auto" takes native while the library is available; without it
    lockstep for 16 or more segments and serial for fewer, and explicit
    "native" raises (jpeg_tpu's tests/test_no_native.py)."""
    data = jt.encode_jpeg(make_ppm(96, 64, seed=7), jt.EncodeParams(
        quality=75, h=2, v=2, optimize=True, restart_interval=ri), "cpu")
    want = jt.decode_jpeg(data, "cpu", entropy="serial").to_pnm()
    calls = []
    for module, name in ((native_entropy, "decode_scan_native"),
                         (lockstep, "decode_scan_lockstep"),
                         (serial, "decode_scan_serial")):
        _record(monkeypatch, module, name, calls)
    assert jt.decode_jpeg(data, "cpu").to_pnm() == want
    assert calls == ["decode_scan_native"]
    calls.clear()
    monkeypatch.setattr(native, "available", lambda: False)
    assert jt.decode_jpeg(data, "cpu").to_pnm() == want
    assert calls == ["decode_scan_lockstep" if ri else "decode_scan_serial"]
    with pytest.raises(jt.UnsupportedError, match="native"):
        jt.decode_coefficients(data, entropy="native")
    for backend in ("serial", "lockstep"):
        assert jt.decode_jpeg(data, "cpu", entropy=backend).to_pnm() == want


def _python_prep(dec, frames, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        return dec.prepare(frames)


def _counts():
    c = default_metrics.counters
    return (c.get("device_decode.native_prep_chunks", 0),
            c.get("device_decode.python_prep_chunks", 0))


@pytest.mark.parametrize("name", SINGLE_SCAN)
def test_native_prep_matches_python_prep(name, monkeypatch):
    frames = frames_of(name)
    dec = DeviceDecoder.for_stream(frames[0], "cpu")
    n0, p0 = _counts()
    words, nbits, qt = dec.prepare(frames)
    assert _counts() == (n0 + 1, p0)
    w_py, n_py, q_py = _python_prep(dec, frames, monkeypatch)
    assert _counts() == (n0 + 1, p0 + 1)
    w = w_py.shape[1]
    assert dec.wn == w  # the sample's segments set pack_words' width
    assert words.dtype == nbits.dtype == torch.int32
    assert words.shape[0] == w_py.shape[0] and words.shape[1] >= w
    assert torch.equal(words[:, :w], w_py) and not words[:, w:].any()
    assert torch.equal(nbits, n_py) and torch.equal(qt, q_py)
    assert qt.stride(0) == 0  # the cached set, nothing uploaded
    got = dec.decode_coeffs_batch(frames)
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        want = dec.decode_coeffs_batch(frames)
    assert torch.equal(got, want)


def test_bad_frames_take_the_python_prep():
    """A truncated frame (its scan ends early) and a chunk whose DQT
    changes from frame to frame (the header differs) go to the Python
    prep; the truncated chunk still warns of its missing MCUs."""
    good = frames_of("yuv420_ri2")[0]
    dec = DeviceDecoder.for_stream(good, "cpu")
    n0, p0 = _counts()
    with pytest.warns(RuntimeWarning, match="MCUs"):
        dec.decode_batch([good, _truncated(good)])
    assert _counts() == (n0, p0 + 1)
    mixed = [jt.encode_jpeg(make_ppm(64, 48, seed=60 + i), jt.EncodeParams(
        h=2, v=2, quality=q, restart_interval=2, optimize=False), "cpu")
        for i, q in enumerate((50, 95))]
    dec = DeviceDecoder.for_stream(mixed[0], "cpu")
    _, _, qt = dec.prepare(mixed)
    assert _counts() == (n0, p0 + 2)
    want = np.stack([parse_codestream(f).qtables for f in mixed])
    np.testing.assert_array_equal(qt.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("wn", [16, None])
def test_native_prep_widens_a_narrow_row(wn, monkeypatch):
    """A row narrower than a segment (``jt_walk_ecs_rows`` returns -2), or one
    that leaves less than ``pack_words``' 8 bytes of slack, widens the
    sticky width and redoes the chunk on the native path."""
    frames = frames_of("bench")
    dec = DeviceDecoder.for_stream(frames[0], "cpu")
    w_py, n_py, _ = _python_prep(dec, frames, monkeypatch)
    lens = (n_py // 8).numpy()
    # None: rows that hold the longest segment with 4 bytes to spare
    dec.wn = wn or (int(lens.max()) + 4 + 3) // 4
    n0, p0 = _counts()
    words, nbits, _ = dec.prepare(frames)
    assert _counts() == (n0 + 1, p0)
    w = w_py.shape[1]
    assert dec.wn >= w and (dec.wn * 4 - int(lens.max())) >= 8
    assert torch.equal(words[:, :w], w_py) and not words[:, w:].any()
    assert torch.equal(nbits, n_py)


@pytest.mark.parametrize("name", ["bench", "yuv420_ri2", "p12_422_ri2",
                                  "short_gray_ri4"])
def test_flat_and_rows_prep_match_pack_words(name):
    for frame in frames_of(name):
        scan = parse_codestream(frame).scans[0]
        seg, offs = unstuff_ranges(frame, scan.ecs_ranges)
        np.testing.assert_array_equal(
            _segment_bytes(frame, scan.ecs_ranges), np.diff(offs))
        want, nbits = pack_words(seg, np.diff(offs))
        S, wn = want.shape
        start = scan.ecs_ranges[0][0]
        rows = np.zeros((S, wn), np.uint32)
        lens = np.zeros(S, np.int32)
        row_map = np.arange(S, dtype=np.int32)
        assert native.prep_ecs_rows_native(frame, start, rows, row_map,
                                           lens) == S
        np.testing.assert_array_equal(rows, want)
        np.testing.assert_array_equal(lens * 8, nbits)
        buf = np.zeros(len(frame) // 4 + S + 16, np.uint32)
        starts = np.zeros(S, np.int32)
        lens[:] = 0
        rc, used = native.prep_ecs_flat_native(frame, start, buf, 0, starts,
                                               lens)
        assert rc == S and used == int(((lens + 3) // 4).sum())
        np.testing.assert_array_equal(lens * 8, nbits)
        for r in range(S):
            n = (int(lens[r]) + 3) // 4
            np.testing.assert_array_equal(buf[starts[r]:starts[r] + n],
                                          want[r, :n])


def _walk_counts():
    c = default_metrics.counters
    return (c.get("native.ecs_walk_frames", 0),
            c.get("native.ecs_walk_refused", 0))


def test_prep_walk_counts_its_frames():
    """The run walk counts each frame it packs: the sample frame in
    ``for_stream``, then each frame of a CPU decode (the rows prep).  A
    frame with a COM marker inside its scan is refused by the rows walk
    and again by the flat one, counted each time, and the chunk takes
    the Python prep."""
    frames = frames_of("bench")
    f0, r0 = _walk_counts()
    dec = DeviceDecoder.for_stream(frames[0], "cpu")
    assert _walk_counts() == (f0 + 1, r0)
    dec.decode_batch(frames)
    assert _walk_counts() == (f0 + 1 + len(frames), r0)
    at = frames[1].index(b"\xff\xd3", dec.scan_start) + 2
    bad = frames[1][:at] + b"\xff\xfe\x00\x02" + frames[1][at:]
    n0, p0 = _counts()
    with pytest.warns(RuntimeWarning, match="MCUs"):
        dec.decode_batch([frames[0], bad])
    assert _walk_counts() == (f0 + 3 + len(frames), r0 + 2)
    assert _counts() == (n0, p0 + 1)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("optimize", [False, True], ids=["default",
                                                         "optimized"])
@pytest.mark.parametrize("ri", [0, 2])
@pytest.mark.parametrize("pnm", [make_ppm(64, 48, seed=5),
                                 make_pgm(40, 40, seed=7)],
                         ids=["ppm", "pgm"])
def test_native_encode_is_byte_identical(pnm, ri, optimize, exact,
                                         monkeypatch):
    kw = dict(h=2, v=2, quality=80, optimize=optimize, restart_interval=ri,
              exact=exact)
    calls = []
    _record(monkeypatch, native, "encode_segments_native", calls)
    got = jt.encode_jpeg(pnm, jt.EncodeParams(entropy_backend="native", **kw),
                         "cpu")
    assert calls == ["encode_segments_native"]
    assert got == jt.encode_jpeg(pnm, jt.EncodeParams(**kw), "cpu")
    assert got == jax_encode(pnm, JParams(**kw))


def test_native_encode_missing_code_raises(monkeypatch):
    """12-bit content under the default (8-bit) tables has DC categories
    with no code: the native coder raises as the NumPy packer does; with
    the library unavailable "native" is the NumPy packer."""
    pnm = make_ppm(48, 40, seed=8, maxval=4095)
    params = jt.EncodeParams(h=2, v=2, quality=80, optimize=False,
                             entropy_backend="native")
    with pytest.raises(jt.UnsupportedError, match="no code"):
        jt.encode_jpeg(pnm, params, "cpu")
    monkeypatch.setattr(native, "available", lambda: False)
    calls = []
    _record(monkeypatch, native, "encode_segments_native", calls)
    with pytest.raises(jt.UnsupportedError, match="no code"):
        jt.encode_jpeg(pnm, params, "cpu")
    params.optimize = True
    assert jt.encode_jpeg(pnm, params, "cpu") == jt.encode_jpeg(
        pnm, jt.EncodeParams(h=2, v=2, quality=80, optimize=True), "cpu")
    assert calls == []
