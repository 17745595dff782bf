"""PyTorch port: the single-image API's ``entropy="lockstep-jax"`` backend
against jpeg_tpu's backend of that name (CPU).

``jpeg_tpu_torch.decode_coefficients(data, entropy="lockstep-jax",
device="cpu")`` runs the plain versions of the general segment decode
(``place_cuda.decode_segments_general_ref``: the eager scan and the
prefix-sum scatter) on every scan; it must equal
``jpeg_tpu.decode_coefficients(data, entropy="lockstep-jax")`` (the JAX
scan on the CPU) integer for integer, ``mcus_decoded`` included, on
intact, truncated, damaged and multi-scan streams.  Around it: the exact
decode and ``mjpeg.decode_stream`` with the backend, a scan of more than
16 blocks per MCU routed to the serial oracle and counted, the required
``device``, and the ``JPEG_TPU_CHECKS=2`` sanitizer tier.

jpeg_tpu's scan compiles once per (plan, lane count, step bound), for
seconds each on a CPU, and again at a larger bound when its first bound (an
estimate from the segment bits) leaves a lane undecoded.  So the streams
are picked to decode within the first bound, and the cases share
programs where they can: the truncated, damaged, exact and stream cases
reuse the 4:2:0 streams'.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jpeg_tpu
from jpeg_tpu import mjpeg as jmjpeg
from jpeg_tpu.constants import DEFAULT_HTABLES
from jpeg_tpu.encoder import EncodeParams, encode_jpeg
from jpeg_tpu.entropy.encode import pack_scan, symbolize_scan
from jpeg_tpu.format import emit
from jpeg_tpu.format.parse import parse_codestream, unstuff
from jpeg_tpu.geometry import Component, FrameGeometry, ScanInfo
from jpeg_tpu.geometry import with_block_grid
from jpeg_tpu.tables import HuffSpec, derive_table

import jpeg_tpu_torch as jt
from jpeg_tpu_torch.entropy import lockstep_torch, place_cuda
from jpeg_tpu_torch.format.parse import parse_codestream as port_parse
from jpeg_tpu_torch.utils.metrics import default_metrics
from refbin import make_pgm, make_ppm

CORPUS = Path(__file__).resolve().parent / "data" / "torch_port"
BACKEND = "lockstep-jax"


def _color(ri):
    """A 4:2:0 stream of 6 x 6 MCUs (ri=3 tiles the MCU rows; ri=16 makes
    a short last segment)."""
    return encode_jpeg(make_ppm(96, 96, seed=1),
                       EncodeParams(h=2, v=2, quality=75,
                                    restart_interval=ri))


def _decode_both(data):
    """(jpeg_tpu's (codestream, planes), the port's on the CPU)."""
    return (jpeg_tpu.decode_coefficients(data, entropy=BACKEND),
            jt.decode_coefficients(data, entropy=BACKEND, device="cpu"))


def _assert_same(data):
    """Coefficients integer for integer and MCU counts: -> the port's
    planes."""
    (jcs, jplanes), (pcs, pplanes) = _decode_both(data)
    assert sorted(pplanes) == sorted(jplanes)
    for cid in jplanes:
        assert pplanes[cid].dtype == np.int32
        np.testing.assert_array_equal(pplanes[cid], jplanes[cid],
                                      err_msg=f"component {cid}")
    assert list(pcs.mcus_decoded) == [int(n) for n in jcs.mcus_decoded]
    return pplanes


def _damage(data):
    """Two stuffed 0xFF bytes (16 one-bits: no code of the K.3 tables) in
    the middle of the second restart segment, whose lane then dies there.
    A byte before them that is 0xFF would make a marker: none is."""
    s, e = parse_codestream(data).scans[0].ecs_ranges[1]
    mid = (s + e) // 2
    assert data[mid - 1] != 0xFF
    return data[:mid] + b"\xff\x00\xff\x00" + data[mid + 4:]


@pytest.mark.parametrize("ri", [1, 3, 16])
def test_color_matches_jax(ri):
    _assert_same(_color(ri))


def test_gray_single_segment_matches_jax():
    jpg = encode_jpeg(make_pgm(32, 24, seed=2),
                      EncodeParams(h=1, v=1, quality=50))
    assert len(parse_codestream(jpg).scans[0].ecs_ranges) == 1
    _assert_same(jpg)


def test_12bit_matches_jax():
    jpg = encode_jpeg(make_ppm(40, 32, seed=42, maxval=4095),
                      EncodeParams(h=2, v=1, quality=50, restart_interval=2))
    assert parse_codestream(jpg).geometry.precision == 12
    _assert_same(jpg)


def test_truncated_stream_matches_jax():
    """The last segment loses its tail (the cut of jpeg_tpu's
    test_lockstep_jax.py): its lane dies short, and the JAX scan's step
    cap and the kernel's unbounded walk give the same counts."""
    jpg = _color(1)
    cut = jpg[:-12] + jpg[-2:]
    _assert_same(cut)
    cs = port_parse(cut)
    mcus = jt.decode_coefficients(cut, entropy=BACKEND,
                                  device="cpu")[0].mcus_decoded
    assert mcus[0] < cs.geometry.n_mcus


def test_damaged_segment_takes_the_prefix_sum():
    """A lane damaged mid-segment: the region kernel would place the next
    lanes' blocks at their fixed offsets, the prefix sum moves them; the
    backend takes the prefix sum, as jpeg_tpu's does (the ri=3 stream
    tiles its MCU rows, so the region path would accept it)."""
    bad = _damage(_color(3))
    planes = _assert_same(bad)
    cs = port_parse(bad)
    scan = cs.scans[0]
    plan = lockstep_torch._cached_plan(cs.geometry, scan.info,
                                       tuple(sorted(scan.htables.items())))
    segs = [unstuff(bad[s:e]) for s, e in scan.ecs_ranges]
    lens = np.array([x.size for x in segs])
    words, nbits = lockstep_torch.pack_words(np.concatenate(segs), lens)
    tb = sum(c.n_blocks for c in cs.geometry.components)
    spf = len(segs)
    assert place_cuda.region_path(plan, spf, scan.ri, tb)
    region, counts = place_cuda.decode_segments(
        plan, torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(nbits.astype(np.int32)), 1, spf, scan.ri, tb)
    assert counts[1] < scan.ri  # the damaged lane died short
    got = np.concatenate([planes[c.cid] for c in cs.geometry.components])
    assert not np.array_equal(region.numpy(), got)


def test_multiscan_corpus_stream_matches_jax():
    """Three non-interleaved scans of two segments each."""
    frame = jmjpeg.split_stream(
        (CORPUS / "multiscan_ri4.mjpeg").read_bytes())[0]
    assert len(parse_codestream(frame).scans) == 3
    _assert_same(frame)


def test_exact_decode_matches_jax():
    jpg = _color(1)
    got = jt.decode_jpeg(jpg, "cpu", exact=True, entropy=BACKEND)
    want = jpeg_tpu.decode_jpeg(jpg, exact=True, entropy=BACKEND)
    assert got.to_pnm() == want.to_pnm()
    assert got.to_pnm() == jt.decode_jpeg(jpg, "cpu", exact=True).to_pnm()


def test_mjpeg_decode_stream_with_the_backend():
    """``mjpeg.decode_stream`` passes the backend and the device down:
    each frame as jpeg_tpu's decode_stream with the same backend, and a
    damaged frame decodes (degrades) instead of failing the stream."""
    frames = [_color(3), _damage(_color(3)), _color(3)]
    stream = b"".join(frames)
    got = jt.mjpeg.decode_stream(stream, "cpu", exact=True, entropy=BACKEND)
    want = jmjpeg.decode_stream(stream, exact=True, entropy=BACKEND)
    assert not got.errors and not want.errors
    assert len(got.frames) == len(want.frames) == 3
    for g, w in zip(got.frames, want.frames):
        assert g.to_pnm() == w.to_pnm()


def _oversized_mcu_frame():
    """One MCU of 18 blocks (luma 4 x 4, two chroma blocks): a scan the
    kernels' 16 slots do not hold, built with jpeg_tpu's emitter."""
    geom = with_block_grid(FrameGeometry(precision=8, height=32, width=32,
                                         components=(
        Component(cid=1, h=4, v=4, tq=0, td=0, ta=0),
        Component(cid=2, h=1, v=1, tq=1, td=1, ta=1),
        Component(cid=3, h=1, v=1, tq=1, td=1, ta=1))))
    rng = np.random.default_rng(5)
    planes = {}
    for c in geom.components:
        p = np.zeros((c.n_blocks, 64), np.int32)
        p[:, 0] = rng.integers(-100, 100, c.n_blocks)
        p[:, 1] = rng.integers(-10, 10, c.n_blocks)
        planes[c.cid] = p
    specs = {k: HuffSpec.from_pair(v) for k, v in DEFAULT_HTABLES.items()}
    info = ScanInfo(component_ids=(1, 2, 3), td=(0, 1, 1), ta=(0, 1, 1))
    segs = pack_scan(symbolize_scan(planes, geom, info),
                     {k: derive_table(s) for k, s in specs.items()})
    qt = np.full((4, 64), 2, np.uint16)
    out = bytearray(emit.emit_soi())
    out += emit.emit_dqt(qt[0], 0) + emit.emit_dqt(qt[1], 1)
    out += emit.emit_sof0(geom)
    for (cls, tid), spec in sorted(specs.items()):
        out += emit.emit_dht(spec, cls, tid)
    out += emit.emit_sos(info) + emit.emit_scan_body(segs)
    out += emit.emit_eoi()
    return bytes(out), planes


def test_oversized_mcu_goes_to_the_serial_oracle():
    jpg, planes = _oversized_mcu_frame()
    key = "lockstep_jax.serial_scans"
    before = default_metrics.counters.get(key, 0)
    got = _assert_same(jpg)
    assert default_metrics.counters[key] == before + 1
    for cid, p in planes.items():
        np.testing.assert_array_equal(got[cid], p)


def test_the_backend_needs_a_device():
    jpg = _color(16)
    with pytest.raises(ValueError, match="device"):
        jt.decode_coefficients(jpg, entropy=BACKEND)
    with pytest.raises(ValueError, match="device"):
        jt.decode_coefficients(jpg, entropy=BACKEND, device=None)


def test_sanitizer_tier_flags_a_corrupt_stream(monkeypatch):
    """JPEG_TPU_CHECKS=2: the stream of jpeg_tpu's checkify test (a
    stuffed 0xFF pair mid-segment) raises ``CorruptStream`` matching
    "sanitizer" in both packages; without the tier it degrades
    gracefully; the intact stream passes the tier equal to the serial
    oracle."""
    jpg = encode_jpeg(make_ppm(48, 40, seed=44),
                      EncodeParams(h=2, v=2, quality=75, restart_interval=2))
    s, e = parse_codestream(jpg).scans[0].ecs_ranges[0]
    mid = (s + e) // 2
    bad = bytearray(jpg)
    bad[mid : mid + 4] = b"\xff\x00\xff\x00"
    bad = bytes(bad)

    monkeypatch.delenv("JPEG_TPU_CHECKS", raising=False)
    jt.decode_coefficients(bad, entropy=BACKEND, device="cpu")  # graceful

    monkeypatch.setenv("JPEG_TPU_CHECKS", "2")
    assert jt.api.checks_level() == 2
    for pkg, kw in ((jpeg_tpu, {}), (jt, {"device": "cpu"})):
        with pytest.raises(pkg.CorruptStream, match="sanitizer"):
            pkg.decode_coefficients(bad, entropy=BACKEND, **kw)
    _, got = jt.decode_coefficients(jpg, entropy=BACKEND, device="cpu")
    monkeypatch.delenv("JPEG_TPU_CHECKS", raising=False)
    _, want = jpeg_tpu.decode_coefficients(jpg, entropy="serial")
    for cid in want:
        np.testing.assert_array_equal(got[cid], want[cid])


def test_plain_checks_pass_intact_scans():
    """The sanitizer's plain scan and placement with their checks on give
    the unchecked results on an intact multi-lane chunk."""
    jpg = _color(3)
    cs = port_parse(jpg)
    scan = cs.scans[0]
    plan = lockstep_torch._cached_plan(cs.geometry, scan.info,
                                       tuple(sorted(scan.htables.items())))
    segs = [unstuff(jpg[s:e]) for s, e in scan.ecs_ranges]
    words, nbits = lockstep_torch.pack_words(
        np.concatenate(segs), np.array([x.size for x in segs]))
    args = (plan, torch.from_numpy(words.view(np.int32)),
            torch.from_numpy(nbits.astype(np.int32)), 1, len(segs),
            sum(c.n_blocks for c in cs.geometry.components))
    plain = place_cuda.decode_segments_general_ref(*args)
    checked = place_cuda.decode_segments_general_ref(*args, checks=True)
    assert all(torch.equal(a, b) for a, b in zip(plain, checked))
