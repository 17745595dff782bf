"""PyTorch port: host copies, committed corpus, guards (CPU only).

The port (``jpeg_tpu_torch``) carries its own copies of the JAX
package's numpy-only host modules; these must agree with the originals
on the committed corpus.  The corpus digests must equal jpeg_tpu's
coefficients, and the port's plain path (what the CUDA kernel is held
against on the card) must reproduce them exactly.
"""

import dataclasses
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jpeg_tpu
from jpeg_tpu import mjpeg as jmjpeg
from jpeg_tpu.encoder import EncodeParams, encode_jpeg, geometry_for_image
from jpeg_tpu.utils.pnm import read_pnm as jax_read_pnm
from jpeg_tpu.entropy.lockstep_jax import _cached_plan as jax_plan
from jpeg_tpu.entropy.lockstep_jax import pack_words as jax_pack_words
from jpeg_tpu.format.parse import parse_codestream as jax_parse
from jpeg_tpu.format.parse import unstuff_ranges as jax_unstuff_ranges

import jpeg_tpu_torch as jt
import jpeg_tpu_torch.native  # noqa: F401 (jt.native)
from jpeg_tpu_torch.entropy import place_cuda
from jpeg_tpu_torch.entropy.lockstep_torch import _cached_plan, pack_words
from jpeg_tpu_torch.format.parse import parse_codestream, unstuff_ranges
from jpeg_tpu_torch.models.device_decode import DeviceDecoder
from jpeg_tpu_torch import encoder as port_encoder
from jpeg_tpu_torch.utils.metrics import default_metrics
from jpeg_tpu_torch.utils.pnm import read_pnm
from refbin import make_pgm, make_ppm

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "tests" / "data" / "torch_port"
DIGESTS = json.loads((CORPUS / "digests.json").read_text())
ELIGIBLE = ["bench", "yuv420_ri2", "yuv444_ri3", "gray_ri4", "p12_422_ri2"]
GENERAL = ["ineligible_420_ri3", "short_422_ri5", "short_p12_420_ri5",
           "row_420_ri3", "short_gray_ri4", "rstless_420"]
OTHER = ["multiscan_ri4", "multiscan_ri0", "mixed_420_ri2"]


def frames_of(name):
    return jmjpeg.split_stream((CORPUS / f"{name}.mjpeg").read_bytes())


def assert_same(a, b, path="root"):
    """Structural equality across the two packages' (distinct) classes."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("path", ["utils/pnm.py", "format/emit.py",
                                  "entropy/encode.py", "entropy/lockstep.py",
                                  "entropy/serial.py", "entropy/native.py",
                                  "native/scanner.cpp"])
def test_encode_host_copies_are_verbatim(path):
    """Numpy-only host modules whose imports are all package-relative, and
    the native layer's C++ source, are carried over byte for byte."""
    assert ((REPO / "jpeg_tpu_torch" / path).read_bytes()
            == (REPO / "jpeg_tpu" / path).read_bytes())


@pytest.mark.parametrize("pnm", [
    make_ppm(37, 21, seed=1),
    make_pgm(16, 9, seed=2),
    make_ppm(20, 12, seed=3, maxval=4095),
])
def test_encoder_params_and_geometry_match_jax(pnm):
    assert ([f.name for f in dataclasses.fields(port_encoder.EncodeParams)]
            == [f.name for f in dataclasses.fields(EncodeParams)])
    assert_same(port_encoder.EncodeParams(), EncodeParams())
    img, ref = read_pnm(pnm, pad_to=(16, 16)), jax_read_pnm(pnm, pad_to=(16, 16))
    assert_same(img, ref)
    for h, v in ((2, 2), (2, 1), (1, 1)):
        kw = dict(h=h, v=v, restart_interval=2, optimize=False)
        assert_same(
            port_encoder.geometry_for_image(img, port_encoder.EncodeParams(**kw)),
            geometry_for_image(ref, EncodeParams(**kw)))


def test_corpus_size():
    total = sum(p.stat().st_size for p in CORPUS.iterdir())
    assert total < 1 << 20
    assert set(DIGESTS) == set(ELIGIBLE + GENERAL + OTHER)
    exact = json.loads((CORPUS / "exact.json").read_text())
    assert set(exact["pnm"]) == set(DIGESTS)
    assert len(exact["pnm"]["bench"]) == 1


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_host_copies_match_jax(name):
    data = (CORPUS / f"{name}.mjpeg").read_bytes()
    frames = jt.mjpeg.split_stream(data)
    assert frames == jmjpeg.split_stream(data)
    assert len(frames) == len(DIGESTS[name])
    for f in frames[:2]:
        cs, ref = parse_codestream(f), jax_parse(f)
        assert_same(cs, ref)
        scan, rscan = cs.scans[0], ref.scans[0]
        plan = _cached_plan(cs.geometry, scan.info,
                            tuple(sorted(scan.htables.items())))
        rplan = jax_plan(ref.geometry, rscan.info,
                         tuple(sorted(rscan.htables.items())))
        assert_same(plan, rplan)
        seg, offs = unstuff_ranges(f, scan.ecs_ranges)
        rseg, roffs = jax_unstuff_ranges(f, rscan.ecs_ranges)
        assert_same((seg, offs), (rseg, roffs))
        assert_same(pack_words(seg, np.diff(offs)),
                    jax_pack_words(rseg, np.diff(roffs)))


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_committed_digests_match_jpeg_tpu(name):
    for frame, want in zip(frames_of(name), DIGESTS[name]):
        cs, planes = jpeg_tpu.decode_coefficients(frame)
        cat = np.concatenate([
            np.asarray(planes[c.cid], np.int32).reshape(-1, 64)
            for c in cs.geometry.components
        ])
        assert hashlib.sha256(cat.tobytes()).hexdigest() == want


@pytest.mark.parametrize("name", ELIGIBLE)
def test_plain_path_matches_digests(name):
    """The plain path on every corpus frame, 1080p included."""
    frames = frames_of(name)
    dec = DeviceDecoder.for_stream(frames[0], "cpu")
    before = place_cuda.decode_segments.launches
    coeffs = dec.decode_coeffs_batch(frames)
    assert coeffs.dtype == torch.int32 and coeffs.device.type == "cpu"
    got = [hashlib.sha256(coeffs[i].numpy().tobytes()).hexdigest()
           for i in range(len(frames))]
    assert got == DIGESTS[name]
    # CPU tensors never reach the kernel: the launch counter stays put.
    assert place_cuda.decode_segments.launches == before == 0


@pytest.mark.parametrize("name", ELIGIBLE)
def test_kernel_block_arithmetic_matches_region_reorder(name):
    """The block index the CUDA kernel computes from the packed tables
    (c0 + my*c1 + mx*c2) equals the TPU path's region -> plane reorder
    (region_to_coeffs) for every (lane, MCU, slot)."""
    frames = frames_of(name)
    dec = DeviceDecoder.for_stream(frames[0], "cpu")
    plan, ri, spf = dec.plan, dec.ri, dec.segs_per_frame
    bpm, tb, nf = plan.blocks_per_mcu, dec.total_blocks, 3
    S, rb = nf * spf, ri * bpm
    ids = torch.arange(S * rb, dtype=torch.int32).reshape(S, rb, 1)
    region = ids.expand(S, rb, 64).reshape(S, rb * 64).contiguous()
    block_id = place_cuda.region_to_coeffs(plan, region, nf, spf, ri)[:, 0]
    assert block_id.shape[0] == nf * tb

    t = place_cuda.kernel_tables(plan).astype(np.int64)
    m_x = place_cuda.kernel_m_x(plan)
    lane = np.arange(S)[:, None, None]
    mcu = np.arange(ri)[None, :, None]
    slot = np.arange(bpm)[None, None, :]
    gm = (lane % spf) * ri + mcu
    blk = ((lane // spf) * tb + t[place_cuda.OFF_C0 + slot]
           + (gm // m_x) * t[place_cuda.OFF_C1 + slot]
           + (gm % m_x) * t[place_cuda.OFF_C2 + slot])
    want = lane * rb + mcu * bpm + slot
    assert np.array_equal(np.sort(blk.ravel()), np.arange(nf * tb))
    np.testing.assert_array_equal(block_id.numpy()[blk], want)


def test_kernel_tables_pack_the_plan():
    frames = frames_of("p12_422_ri2")
    plan = DeviceDecoder.for_stream(frames[0], "cpu").plan
    t = place_cuda.kernel_tables(plan)
    T = plan.maxcode.shape[0]
    assert t.shape == (place_cuda.TABLE_INTS,) and t.dtype == np.int32
    for name, off, width in (("maxcode", place_cuda.OFF_MAXCODE, 17),
                             ("valptr", place_cuda.OFF_VALPTR, 17),
                             ("huffval", place_cuda.OFF_HUFFVAL, 256)):
        np.testing.assert_array_equal(
            t[off : off + T * width].reshape(T, width), getattr(plan, name))
    # unused table rows never match a code
    assert (t[place_cuda.OFF_MAXCODE + T * 17 : place_cuda.OFF_MINCODE]
            == -1).all()


def test_ineligible_stream_raises():
    """A stream whose segments do not tile MCU rows now decodes (the
    general-shape path) to jpeg_tpu's coefficients; only the region
    path's plain version still refuses the shape."""
    frame = frames_of("ineligible_420_ri3")[0]
    dec = DeviceDecoder.for_stream(frame, "cpu")
    coeffs = dec.decode_coeffs_batch([frame])
    assert hashlib.sha256(coeffs[0].numpy().tobytes()).hexdigest() == \
        DIGESTS["ineligible_420_ri3"][0]
    px = jt.mjpeg.decode_stream_device(frame, "cpu")
    np.testing.assert_array_equal(px.numpy(), dec.decode_batch([frame]))
    cs = parse_codestream(frame)
    scan = cs.scans[0]
    plan = _cached_plan(cs.geometry, scan.info,
                        tuple(sorted(scan.htables.items())))
    seg, offs = unstuff_ranges(frame, scan.ecs_ranges)
    words, nbits = pack_words(seg, np.diff(offs))
    tb = sum(c.n_blocks for c in cs.geometry.components)
    args = (plan, torch.from_numpy(words.view(np.int32)),
            torch.from_numpy(nbits.astype(np.int32)), 1,
            len(scan.ecs_ranges), scan.ri, tb)
    with pytest.raises(jt.UnsupportedError, match="tile"):
        place_cuda.decode_segments_ref(*args)
    assert torch.equal(place_cuda.decode_segments(*args)[0], coeffs[0])


def test_rstless_stream_raises():
    """An RST-less stream decodes, small frames one lane per frame, and so
    do ``entropy="speculative"`` and ``entropy="native"``; explicit
    ``"native"`` raises only when the native library is not available."""
    params = EncodeParams(h=2, v=2, quality=75, restart_interval=0,
                          optimize=False, exact=False)
    jpeg = encode_jpeg(make_ppm(64, 32, seed=3), params)
    px = jt.mjpeg.decode_stream_device(jpeg + jpeg, "cpu")
    cs, planes = jpeg_tpu.decode_coefficients(jpeg)
    want = np.concatenate([planes[c.cid] for c in cs.geometry.components])
    dec = DeviceDecoder.for_stream(jpeg, "cpu")
    assert dec.segs_per_frame == 1 and dec.ri == 0
    np.testing.assert_array_equal(dec.decode_coeffs_batch([jpeg])[0], want)
    np.testing.assert_array_equal(px[1].numpy(), px[0].numpy())
    got = jt.decode_coefficients(jpeg, entropy="speculative", device="cpu")[1]
    for cid in planes:
        np.testing.assert_array_equal(got[cid], planes[cid])
    got = jt.decode_coefficients(jpeg, entropy="native")[1]
    for cid in planes:
        np.testing.assert_array_equal(got[cid], planes[cid])
    mp = pytest.MonkeyPatch()
    mp.setattr(jt.native, "available", lambda: False)
    try:
        with pytest.raises(jt.UnsupportedError, match="native"):
            jt.decode_jpeg(jpeg, "cpu", entropy="native")
    finally:
        mp.undo()


def test_no_frames_raises():
    with pytest.raises(jt.FileIOError):
        jt.mjpeg.decode_stream_device(b"not a jpeg stream", "cpu")


def test_truncated_frame_fires_short_mcu_warning():
    frames = frames_of("yuv420_ri2")
    good = frames[0]
    # Empty the final restart segment: keep the last RSTn, drop the tail
    # ECS bytes, close with EOI -- 2 MCUs short of the geometry.
    last = max(good.rfind(bytes([0xFF, 0xD0 + k])) for k in range(8))
    bad = good[: last + 2] + b"\xff\xd9"
    dec = DeviceDecoder.for_stream(good, "cpu")
    before = default_metrics.counters.get("device_decode.short_mcus", 0)
    with pytest.warns(RuntimeWarning, match="MCUs"):
        px = dec.decode_batch([good, bad])
    assert default_metrics.counters["device_decode.short_mcus"] == before + 1
    np.testing.assert_array_equal(px[0].numpy(),
                                  dec.decode_batch([good])[0].numpy())


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    frames = frames_of("yuv420_ri2")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceDecoder.for_stream(frames[0], "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        jt.mjpeg.decode_stream_device(b"".join(frames), "cuda")
    assert place_cuda.decode_segments.launches == 0


def test_wrapper_refuses_other_devices():
    frames = frames_of("yuv420_ri2")
    dec = DeviceDecoder.for_stream(frames[0], "cpu")
    words, nbits, _ = dec.prepare(frames[:1])
    with pytest.raises(ValueError, match="device"):
        place_cuda.decode_segments(
            dec.plan, words.to("meta"), nbits.to("meta"), 1,
            dec.segs_per_frame, dec.ri, dec.total_blocks)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import jpeg_tpu_torch\n"
        "for m in pkgutil.walk_packages(jpeg_tpu_torch.__path__, "
        "'jpeg_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib', 'jpeg_tpu.')) or m == 'jpeg_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "ok"
