"""PyTorch port: per-frame optimized Huffman tables.

``DeviceEncoder.encode_batch(optimize="frame")`` gives each frame the
Annex K.2 tables of its own symbols and its own DHT, as ``cjpeg
-optimize`` writes a file.  Held here on the CPU at small sizes:

- the per-frame histogram (each frame's table rows apart) against the
  histogram of each frame taken alone;
- the native K.2 builder (``native/optimal_tables.cpp``) against
  ``tables.optimize_table`` and ``derive_table`` on seeded histograms,
  ties, one symbol, all 256, codes the 16-bit adjustment shortens, and
  no symbol or code sizes past 32 bits (both refuse);
- each frame against jpeg_tpu's single-image encoder with
  ``optimize=True`` on the same quantized planes, byte for byte, the
  planes read back by jpeg_tpu's serial oracle; the same bytes without
  the native library, counted as Python builds (an encoder on a card
  raises instead);
- with the shared and with per-batch tables, each frame against
  jpeg_tpu's single-image encoder with those tables on the same planes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jpeg_tpu
from jpeg_tpu import encoder as jpeg_encoder
from jpeg_tpu.encoder import EncodeParams as JEncodeParams
from jpeg_tpu.encoder import encode_jpeg_from_planes
from jpeg_tpu.entropy.encode import histogram, symbolize_scan
from jpeg_tpu.geometry import ScanInfo
from jpeg_tpu.tables import optimize_table

import jpeg_tpu_torch as jt
from jpeg_tpu_torch import native, tables
from jpeg_tpu_torch.encoder import EncodeParams
from jpeg_tpu_torch.errors import LogicError
from jpeg_tpu_torch.models.encode_dense import raster_to_zz
from jpeg_tpu_torch.utils.metrics import default_metrics
from jpeg_tpu_torch.utils.pnm import read_pnm
import jpeg_tpu_lib
from refbin import make_pgm, make_ppm

jpeg_tpu_lib.build_once()  # jpeg_tpu's library, whole, before any test

# name -> (components, h, v, height, width, precision, restart interval)
GEOMETRIES = {
    "420_ri4": (3, 2, 2, 48, 64, 8, 4),  # the benchmark cell's shape
    "gray_ri3": (1, 1, 1, 37, 45, 8, 3),
    "p12_422_ri2": (3, 2, 1, 32, 48, 12, 2),
}
QUALITY = 75
BUILDS = ("device_encode.native_table_builds",
          "device_encode.python_table_builds")


def _encoder(case):
    comps, h, v, height, width, precision, ri = GEOMETRIES[case]
    return jt.DeviceEncoder.for_config(
        height, width, comps,
        EncodeParams(h=h, v=v, quality=QUALITY, optimize=False,
                     restart_interval=ri, exact=False),
        precision=precision, device="cpu")


def _frames(case, n=3):
    comps, _, _, height, width, precision, _ = GEOMETRIES[case]
    make = make_ppm if comps == 3 else make_pgm
    px = np.stack([read_pnm(make(width, height, seed=30 + i,
                                 maxval=(1 << precision) - 1)).data
                   for i in range(n)])
    return torch.from_numpy(px.astype(np.uint8 if precision <= 8
                                      else np.uint16))


def _builds():
    return [default_metrics.counters[k] for k in BUILDS]


@pytest.mark.parametrize("case", list(GEOMETRIES))
def test_per_frame_histogram_is_each_frames_own(case):
    enc = _encoder(case)
    zz = enc.dense(_frames(case))
    T, bf = len(enc.table_keys), enc.blocks_per_frame
    got = enc.histogram(zz, per_frame=True)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3 * T, 256)
    for f in range(3):
        assert got[f * T:(f + 1) * T].equal(
            enc.histogram(zz[f * bf:(f + 1) * bf]))
    assert got.reshape(3, T, 256).sum(0).equal(enc.histogram(zz))
    assert not got[:T].equal(got[T:2 * T])  # the frames differ


def _k2_case(case):
    """[n, 256] int32 histograms of one kind."""
    rng = np.random.default_rng(sorted(K2_CASES).index(case))
    if case.startswith("random"):
        hist = np.zeros((24, 256), np.int32)
        for row in hist:
            k = int(rng.integers(1, 257))
            top = int(rng.choice([3, 50, 10 ** 4, 2 ** 31 - 1]))
            row[rng.choice(256, k, replace=False)] = rng.integers(1, top, k)
        return hist
    if case == "ties":
        hist = np.zeros((3, 256), np.int32)
        hist[0] = 7
        hist[1, [0, 5, 9, 200, 255]] = 3
        hist[2, ::3] = rng.integers(1, 3, hist[2, ::3].size)
        return hist
    if case == "single":
        hist = np.zeros((2, 256), np.int32)
        hist[0, 0], hist[1, 255] = 1, 10 ** 6
        return hist
    if case == "all_256":
        return rng.integers(1, 10 ** 5, (4, 256)).astype(np.int32)
    fib = [1, 1]
    while len(fib) < 40:
        fib.append(fib[-1] + fib[-2])
    hist = np.zeros((2, 256), np.int32)
    if case == "adjust_16":  # Fibonacci counts: code sizes 21 and 30
        hist[0, :40] = fib
        hist[1, 226:] = fib[29::-1]
        return hist
    if case == "past_32_bits":  # code size 40: both builders refuse
        hist[1, 216:] = fib[::-1]
        hist[0, 7] = 1
        return hist
    return np.zeros((1, 256), np.int32)  # "empty"


K2_CASES = ("random0", "random1", "random2", "ties", "single", "all_256",
            "adjust_16", "past_32_bits", "empty")


@pytest.mark.parametrize("case", K2_CASES)
def test_native_tables_equal_optimize_table(case):
    assert native.available()
    hist = _k2_case(case)
    if case in ("empty", "past_32_bits"):
        with pytest.raises(IndexError if case == "empty" else LogicError):
            tables.optimize_table(hist[-1])
        with pytest.raises(ValueError, match=f"histogram {len(hist) - 1} "):
            native.optimal_tables_native(hist)
        return
    bits, values, ehufco, ehufsi = native.optimal_tables_native(hist)
    for t, row in enumerate(hist):
        spec = tables.optimize_table(row)
        n = len(spec.values)
        assert tuple(bits[t]) == spec.counts, t
        assert tuple(values[t, :n]) == spec.values and not values[t, n:].any()
        derived = tables.derive_table(spec, build_lut=False)
        np.testing.assert_array_equal(ehufco[t], derived.ehufco)
        np.testing.assert_array_equal(ehufsi[t], derived.ehufsi)
    if case == "adjust_16":
        for row, size in zip(hist, (21, 30)):
            freq = np.append(row.astype(np.int64), 1)
            assert tables._code_sizes_from_freq(freq).max() == size
        assert bits.sum(1).tolist() == [40, 30]


def _single_image(jpeg: bytes, case) -> bytes:
    """jpeg_tpu's single-image optimized encode of the planes the serial
    oracle reads from ``jpeg``."""
    comps, h, v, _, _, _, ri = GEOMETRIES[case]
    cs, planes = jpeg_tpu.decode_coefficients(jpeg, entropy="serial")
    qt = np.ones((4, 64), np.uint16)
    qt[:2] = _encoder(case).qtables
    return encode_jpeg_from_planes(
        {k: np.asarray(p) for k, p in planes.items()}, cs.geometry, qt,
        JEncodeParams(h=h, v=v, quality=QUALITY, optimize=True,
                      restart_interval=ri))


def _blocks_of(jpeg: bytes, enc) -> np.ndarray:
    """The serial oracle's blocks of ``jpeg`` in the encoder's layout."""
    cs, planes = jpeg_tpu.decode_coefficients(jpeg, entropy="serial")
    comps = sorted(cs.geometry.components, key=lambda c: c.cid)
    raster = np.concatenate([np.asarray(planes[c.cid], np.int32)
                             .reshape(-1, 64) for c in comps])
    return raster_to_zz(torch.from_numpy(raster)[None],
                        torch.from_numpy(enc.prev_idx)).numpy()


@pytest.mark.parametrize("case", list(GEOMETRIES))
def test_frame_tables_match_single_image_encoder(case):
    """Each frame is jpeg_tpu's single-image optimized encode of the same
    quantized planes, byte for byte, and decodes on the serial oracle to
    exactly the port's blocks; 3 frames at chunk 2, one native build a
    table."""
    enc = _encoder(case)
    px = _frames(case)
    before = _builds()
    got = enc.encode_batch(px, optimize="frame", chunk=2)
    T = len(enc.table_keys)
    assert [a - b for a, b in zip(_builds(), before)] == [3 * T, 0]
    blocks = enc.dense(px).numpy().reshape(3, -1, 64)
    for i, frame in enumerate(got):
        np.testing.assert_array_equal(_blocks_of(frame, enc), blocks[i])
        assert frame == _single_image(frame, case), i
    headers = {f[:f.index(b"\xff\xda")] for f in got}
    assert len(headers) == 3  # each frame has its own tables


@pytest.mark.parametrize("case", ["without_library", "failed_build_on_card"])
def test_frame_tables_without_library(monkeypatch, case):
    """Without the native library the Python builder makes the same
    tables, so the same bytes, and only it is counted; an encoder on a
    card raises instead, with the build's error."""
    enc = _encoder("420_ri4")
    if case == "failed_build_on_card":
        def failed_build():
            raise RuntimeError("g++ failed (1):\noptimal_tables.cpp: error")

        enc = dataclasses.replace(enc, device=torch.device("cuda"))
        monkeypatch.setattr(native, "load_library", failed_build)
        native._attempt.cache_clear()
        try:
            with pytest.warns(RuntimeWarning, match="optimal_tables.cpp"):
                assert not native.available()
            before = _builds()
            with pytest.raises(RuntimeError, match="optimal_tables.cpp"):
                enc.frame_tables(np.ones((4, 256), np.int32))
            assert _builds() == before
        finally:
            native._attempt.cache_clear()
        return
    px = _frames("420_ri4")
    want = enc.encode_batch(px, optimize="frame", chunk=2)
    monkeypatch.setattr(native, "available", lambda: False)
    before = _builds()
    assert enc.encode_batch(px, optimize="frame", chunk=2) == want
    assert [a - b for a, b in zip(_builds(), before)] \
        == [0, 3 * len(enc.table_keys)]


@pytest.mark.parametrize("case", ["420_ri4", "gray_ri3"])
def test_frame_tables_chunks(case):
    """A chunk holds at most ``frames_per_scan`` frames (the kernels'
    ``T_MAX`` stacked tables: 8 frames in colour, 16 in gray); the bytes
    do not depend on the chunk."""
    enc = _encoder(case)
    assert enc.frames_per_scan == {"420_ri4": 8, "gray_ri3": 16}[case]
    px = _frames(case, 5)
    one = enc.encode_batch(px, optimize="frame", chunk=1)
    assert enc.encode_batch(px, optimize="frame", chunk=0) == one
    assert enc.encode_batch(px, optimize="frame", chunk=3) == one
    with pytest.raises(ValueError, match="optimize"):
        enc.encode_batch(px, optimize="batch")


def _single_image_with(jpeg: bytes, case, htables) -> bytes:
    """jpeg_tpu's single-image encode, with Huffman tables ``htables``
    ({(class, id): (counts, values)}), of the planes the serial oracle
    reads from ``jpeg``."""
    comps, h, v, _, _, _, ri = GEOMETRIES[case]
    cs, planes = jpeg_tpu.decode_coefficients(jpeg, entropy="serial")
    qt = np.ones((4, 64), np.uint16)
    qt[:2] = _encoder(case).qtables
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpeg_encoder, "DEFAULT_HTABLES", htables)
        return encode_jpeg_from_planes(
            {k: np.asarray(p) for k, p in planes.items()}, cs.geometry, qt,
            JEncodeParams(h=h, v=v, quality=QUALITY, optimize=False,
                          restart_interval=ri))


def _batch_tables(frames, case) -> dict:
    """The Annex K.2 tables of the symbols of all ``frames`` together, by
    jpeg_tpu's dry pass and ``optimize_table``."""
    _, _, _, _, _, _, ri = GEOMETRIES[case]
    total = {}
    for jpeg in frames:
        cs, planes = jpeg_tpu.decode_coefficients(jpeg, entropy="serial")
        comps = sorted(cs.geometry.components, key=lambda c: c.cid)
        info = ScanInfo(component_ids=tuple(c.cid for c in comps),
                        td=tuple(c.td for c in comps),
                        ta=tuple(c.ta for c in comps))
        freq = histogram(symbolize_scan(
            {k: np.asarray(p) for k, p in planes.items()}, cs.geometry,
            info, ri))
        for k, counts in freq.items():
            total[k] = total.get(k, 0) + counts
    specs = {k: optimize_table(c) for k, c in total.items()}
    return {k: (s.counts, s.values) for k, s in specs.items()}


@pytest.mark.parametrize("case", list(GEOMETRIES))
def test_shared_and_per_batch_tables_keep_their_bytes(case):
    """With the shared (Annex K) tables and with per-batch tables, each
    frame is jpeg_tpu's single-image encode of the same quantized planes
    with those tables, byte for byte; the per-batch tables are the K.2
    tables of the batch's summed symbols."""
    enc = _encoder(case)
    px = _frames(case)
    shared = enc.encode_batch(px, optimize=False, chunk=2)
    for i, frame in enumerate(shared):
        assert frame == _single_image_with(
            frame, case, jpeg_encoder.DEFAULT_HTABLES), i
    batch = enc.encode_batch(px, optimize=True, chunk=2)
    htables = _batch_tables(batch, case)
    for i, frame in enumerate(batch):
        assert frame == _single_image_with(frame, case, htables), i
    assert len({f[:f.index(b"\xff\xda")] for f in batch}) == 1
