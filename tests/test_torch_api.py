"""PyTorch port: the single-image API and the exact mode vs jpeg_tpu (CPU).

``jpeg_tpu_torch.decode_jpeg(data, "cpu", exact=True).to_pnm()`` must be
byte-identical to ``jpeg_tpu.decode_jpeg(data, exact=True).to_pnm()``
(4:2:0, 4:2:2, 4:4:4, grayscale, 12-bit, YCCK and a non-dividing sampling
ratio), and ``encode_jpeg(..., exact=True)`` byte-identical to
``jpeg_tpu.encode_jpeg`` (optimize on and off, restart interval 0 and 3,
NumPy and device entropy backends): the plain versions of the exact
kernels (``models/dense_exact.py``) are bitwise equal to the JAX
package's eager exact ops.  The fast mode (``exact=False``) stays within
+-1 per sample.  ``DeviceEncoder.tables_for_stream`` equals jpeg_tpu's.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jpeg_tpu
from jpeg_tpu import mjpeg as jmjpeg
from jpeg_tpu.constants import DEFAULT_HTABLES
from jpeg_tpu.encoder import EncodeParams as JParams
from jpeg_tpu.encoder import encode_jpeg as jax_encode
from jpeg_tpu.entropy.encode import pack_scan, symbolize_scan
from jpeg_tpu.format import emit
from jpeg_tpu.geometry import Component, FrameGeometry, ScanInfo
from jpeg_tpu.geometry import with_block_grid
from jpeg_tpu.models.device_encode import DeviceEncoder as JaxEncoder
from jpeg_tpu.ops import color as jcolor
from jpeg_tpu.ops import dct as jdct
from jpeg_tpu.ops import quant as jquant
from jpeg_tpu.tables import HuffSpec, derive_table

import jpeg_tpu_torch as jt
import jpeg_tpu_torch.native  # noqa: F401 (jt.native)
from jpeg_tpu_torch.encoder import EncodeParams
from jpeg_tpu_torch.models import dense_exact
from jpeg_tpu_torch.ops import color, dct
from jpeg_tpu_torch.utils import synth
from refbin import make_pgm, make_ppm

CORPUS = Path(__file__).resolve().parent / "data" / "torch_port"
EXACT = json.loads((CORPUS / "exact.json").read_text())

# name -> (h, v, width, height, gray, maxval): odd sizes pad every edge.
SHAPES = {
    "420": (2, 2, 37, 29, False, 255),
    "422": (2, 1, 40, 21, False, 255),
    "444": (1, 1, 24, 17, False, 255),
    "gray": (1, 1, 30, 20, True, 255),
    "p12": (2, 2, 32, 24, False, 4095),
}


def _pnm(name):
    h, v, w, ht, gray, maxval = SHAPES[name]
    return (make_pgm if gray else make_ppm)(w, ht, seed=3, maxval=maxval)


def _crafted(components, info_tables, seed):
    """A frame the JAX encoder cannot emit, built from random planes with
    the JAX package's own emitter (as tests/test_crafted_streams.py)."""
    geom = with_block_grid(FrameGeometry(precision=8, height=24, width=40,
                                         components=components))
    rng = np.random.default_rng(seed)
    planes = {}
    for c in geom.components:
        p = np.zeros((c.n_blocks, 64), np.int32)
        p[:, 0] = rng.integers(-150, 150, c.n_blocks)
        for k in (1, 2, 8, 9, 16):
            p[:, k] = rng.integers(-20, 20, c.n_blocks)
        planes[c.cid] = p
    qt = np.full((4, 64), 3, np.uint16)
    specs = {k: HuffSpec.from_pair(v) for k, v in DEFAULT_HTABLES.items()}
    info = ScanInfo(component_ids=tuple(c.cid for c in components),
                    td=info_tables, ta=info_tables)
    segs = pack_scan(symbolize_scan(planes, geom, info),
                     {k: derive_table(s) for k, s in specs.items()})
    out = bytearray(emit.emit_soi())
    out += emit.emit_dqt(qt[0], 0) + emit.emit_dqt(qt[1], 1)
    out += emit.emit_sof0(geom)
    for key in ((0, 0), (1, 0), (0, 1), (1, 1)):
        out += emit.emit_dht(specs[key], *key)
    out += emit.emit_sos(info) + emit.emit_scan_body(segs) + emit.emit_eoi()
    return bytes(out)


@pytest.fixture(scope="module")
def frames():
    """name -> JPEG bytes for every exact-decode case (``NAMES``)."""
    out = {name: jax_encode(_pnm(name), JParams(
        h=SHAPES[name][0], v=SHAPES[name][1], quality=85, optimize=True,
        restart_interval=2, exact=True)) for name in SHAPES}
    # Non-dividing sampling (h = 3, 2, 1): the reference leaves the
    # margin of the middle component's upsampled plane at 0.0.
    out["nondividing"] = _crafted(
        (Component(cid=1, h=3, v=1, tq=0, td=0, ta=0),
         Component(cid=2, h=2, v=1, tq=1, td=1, ta=1),
         Component(cid=3, h=1, v=1, tq=1, td=1, ta=1)), (0, 1, 1), seed=7)
    out["ycck"] = _crafted(tuple(
        Component(cid=i, h=1, v=1, tq=int(i in (2, 3)), td=int(i in (2, 3)),
                  ta=int(i in (2, 3))) for i in (1, 2, 3, 4)),
        (0, 1, 1, 0), seed=8)
    return out


NAMES = list(SHAPES) + ["nondividing", "ycck"]


@pytest.mark.parametrize("name", NAMES)
def test_exact_decode_is_byte_identical(frames, name):
    data = frames[name]
    want = jpeg_tpu.decode_jpeg(data, exact=True)
    got = jt.decode_jpeg(data, "cpu", exact=True)
    assert isinstance(got, jt.DecodedImage)
    assert got.frame.dtype == np.float32
    assert got.frame.shape == want.frame.shape
    assert got.to_pnm() == want.to_pnm()
    np.testing.assert_array_equal(got.frame.view(np.uint32),
                                  np.asarray(want.frame).view(np.uint32))
    for cid, plane in want.coefficients.items():
        np.testing.assert_array_equal(got.coefficients[cid], plane)
    fast = jt.decode_jpeg(data, "cpu", exact=False).pixels()
    assert np.abs(fast - want.pixels()).max() <= 1


@pytest.mark.parametrize("name", sorted(EXACT["pnm"]))
def test_committed_exact_digests(name):
    """The corpus frames (bench frame 0 at 1080p included) against the
    committed digests of jpeg_tpu's exact decode."""
    frames = jmjpeg.split_stream((CORPUS / f"{name}.mjpeg").read_bytes())
    got = [hashlib.sha256(jt.decode_jpeg(f, "cpu").to_pnm()).hexdigest()
           for f in frames[:len(EXACT["pnm"][name])]]
    assert got == EXACT["pnm"][name]


# 12-bit content needs optimized tables (the defaults lack its codes).
ENCODES = [(name, opt, ri) for name in ("420", "422", "gray", "p12")
           for opt in (False, True) for ri in (0, 3)
           if opt or name != "p12"]


@pytest.mark.parametrize("name,optimize,ri", ENCODES)
def test_exact_encode_is_byte_identical(name, optimize, ri):
    h, v = SHAPES[name][:2]
    fields = dict(h=h, v=v, quality=80, optimize=optimize,
                  restart_interval=ri, exact=True)
    want = jax_encode(_pnm(name), JParams(**fields))
    assert jt.encode_jpeg(_pnm(name), EncodeParams(**fields), "cpu") == want
    dev = jt.encode_jpeg(_pnm(name), EncodeParams(entropy_backend="jax",
                                                  **fields), "cpu")
    assert dev == want


def test_fast_encode_and_native_backend(monkeypatch):
    """exact=False: the float32 matmul forms; the blocks may differ from
    jpeg_tpu's on rounding boundaries, so the check is the decode (+-1
    against jpeg_tpu's decode of its own fast encode).  "native" codes
    with the threaded C++ coder, byte-identical to the NumPy packer."""
    fields = dict(h=2, v=2, quality=80, optimize=False, restart_interval=2,
                  exact=False)
    pnm = _pnm("420")
    got = jt.encode_jpeg(pnm, EncodeParams(**fields), "cpu")
    calls = []
    coder = jt.native.encode_segments_native
    monkeypatch.setattr(jt.native, "encode_segments_native",
                        lambda *a: calls.append(1) or coder(*a))
    native = jt.encode_jpeg(pnm, EncodeParams(entropy_backend="native",
                                              **fields), "cpu")
    assert native == got and calls == [1]
    want = jax_encode(pnm, JParams(**fields))
    a = jpeg_tpu.decode_jpeg(got, exact=True).pixels()
    b = jpeg_tpu.decode_jpeg(want, exact=True).pixels()
    assert np.abs(a - b).max() <= 1


@pytest.mark.parametrize("name", ["420", "p12"])
def test_tables_for_stream_matches_jax(name):
    h, v = SHAPES[name][:2]
    fields = dict(h=h, v=v, quality=80, optimize=False, restart_interval=2,
                  exact=False)
    got = jt.DeviceEncoder.tables_for_stream(_pnm(name),
                                             EncodeParams(**fields), "cpu")
    want = JaxEncoder.tables_for_stream(_pnm(name), JParams(**fields))
    assert sorted(got) == sorted(want)
    for k in want:
        assert (got[k].counts, got[k].values) == \
            (want[k].counts, want[k].values)


def test_exact_plain_ops_match_jax_bitwise():
    """The exact DCTs and colour forms, op for op, on seeded data: the
    plain versions of the K4 kernels equal the JAX package's eager ops."""
    rng = np.random.default_rng(0)
    blocks = rng.normal(0, 300, (40, 8, 8)).astype(np.float32)
    for port, jax_fn in ((dct.idct8x8_exact, jdct.idct8x8_exact),
                         (dct.fdct8x8_exact, jdct.fdct8x8_exact)):
        np.testing.assert_array_equal(
            port(torch.from_numpy(blocks)).numpy().view(np.uint32),
            np.asarray(jax_fn(blocks)).view(np.uint32))
    px = rng.uniform(-20, 4200, (13, 11, 4)).astype(np.float32)
    for prec in (8, 12):
        for port, jax_fn, arr in (
                (color.rgb_to_ycc, jcolor.rgb_to_ycc, px[..., :3]),
                (color.ycc_to_rgb, jcolor.ycc_to_rgb, px[..., :3]),
                (color.ycck_to_rgb, jcolor.ycck_to_rgb, px)):
            got = port(torch.from_numpy(np.ascontiguousarray(arr)), prec,
                       exact=True).numpy()
            np.testing.assert_array_equal(
                got.view(np.uint32),
                np.asarray(jax_fn(arr, prec, exact=True)).view(np.uint32))
    # the matmul forms stay within float32 noise of jpeg_tpu's
    np.testing.assert_allclose(
        dct.idct8x8_matmul(torch.from_numpy(blocks)).numpy(),
        np.asarray(jdct.idct8x8_matmul(blocks)), atol=1e-3)
    np.testing.assert_allclose(
        dct.fdct8x8_matmul(torch.from_numpy(blocks)).numpy(),
        np.asarray(jdct.fdct8x8_matmul(blocks)), atol=1e-3)


@pytest.mark.parametrize("case", synth.FDCT_CASES)
def test_fdct_exact_ref_matches_jax_hostile(case):
    """The exact FDCT + quantizer's plain version equals jpeg_tpu's
    ``fdct8x8_exact`` + ``quantize`` bit for bit on ``synth.hostile_fdct``:
    12-bit samples, quotients on exact .5 ties (rounded away from zero)
    and tables of all 1 and all 255."""
    samples, q, bits = synth.hostile_fdct(case)
    assert samples.shape[0] > 0
    got = dense_exact.fdct_exact_ref(torch.from_numpy(samples),
                                     torch.from_numpy(q), bits)
    x = (samples - np.float32(1 << (bits - 1))).reshape(-1, 8, 8)
    want = np.asarray(jquant.quantize(
        np.asarray(jdct.fdct8x8_exact(x)).reshape(-1, 64), q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case.startswith("ties"):
        # every block holds a quotient exactly on .5 in float32
        c = dct.fdct8x8_exact(torch.from_numpy(x)).reshape(-1, 64).numpy()
        mag = np.abs((c / q.astype(np.float32)).astype(np.float64))
        assert ((mag - np.floor(mag)) == 0.5).any(axis=1).all()


def test_exact_wrappers_on_cpu_and_other_devices(frames):
    """CPU tensors take the plain versions (no launch counted); any other
    device raises; the entropy backends that are not ported raise."""
    coeffs = torch.zeros(2, 64, dtype=torch.int32)
    q = torch.ones(64, dtype=torch.int32)
    out = dense_exact.idct_exact(coeffs, q, 8)
    assert out.dtype == torch.float32 and (out == 128).all()
    assert dense_exact.fdct_exact(out, q, 8).abs().max() == 0
    assert dense_exact.idct_exact.launches == 0
    assert dense_exact.fdct_exact.launches == 0
    assert dense_exact.color_exact.launches == 0
    with pytest.raises(ValueError, match="device"):
        dense_exact.idct_exact(coeffs.to("meta"), q.to("meta"), 8)
    with pytest.raises(ValueError, match="device"):
        dense_exact.color_exact(torch.zeros(2, 3, device="meta"), 8,
                                "to_rgb")
    with pytest.raises(ValueError, match="mode"):
        dense_exact.color_exact(torch.zeros(2, 3), 8, "to_cmyk")
    data = frames["420"]
    native = jt.decode_coefficients(data, entropy="native")[1]
    lock = jt.decode_coefficients(data, entropy="lockstep")[1]
    serial = jt.decode_coefficients(data, entropy="serial")[1]
    spec = jt.decode_coefficients(data, entropy="speculative",
                                  device="cpu")[1]
    for cid in lock:
        np.testing.assert_array_equal(native[cid], serial[cid])
        np.testing.assert_array_equal(lock[cid], serial[cid])
        np.testing.assert_array_equal(spec[cid], serial[cid])


def test_decode_stream_isolates_bad_frames(frames):
    good = frames["420"]
    bad = good[: len(good) // 2] + b"\xff\xd9"
    res = jt.mjpeg.decode_stream(good + b"\xff\xd8\xff\xd9" + good, "cpu")
    want = jpeg_tpu.mjpeg.decode_stream(good + b"\xff\xd8\xff\xd9" + good)
    assert res.ok_count == want.ok_count
    assert [e[0] for e in res.errors] == [e[0] for e in want.errors]
    res = jt.mjpeg.decode_stream(good + bad, "cpu", exact=True)
    assert res.frames[0].to_pnm() == jpeg_tpu.decode_jpeg(good).to_pnm()
