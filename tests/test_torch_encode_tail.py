"""PyTorch port: the native encode host tail against its plain version.

``native.finalize_flat_native`` (``native/encode_tail.cpp``) turns a
chunk's compacted segment words into framed JPEG bytes in one pass;
``DeviceEncoder._finalize_flat_ref`` is its NumPy plain version.  Held
here byte for byte on synthetic word streams: empty, one-bit, byte- and
word-boundary segments, a last byte that padding turns into 0xFF, words
of 0xFF only, one segment a frame and RSTn wrapping past RST7, one and
eight frames, the encoder's header, a per-batch one and one a frame
(per-frame tables).  A capacity below the worst case, a stream short of
words and a negative header length are refused.  Without the library
``encode_batch`` takes the plain version, except on a card.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import jpeg_tpu_torch as jt
from jpeg_tpu_torch import native
from jpeg_tpu_torch.encoder import EncodeParams
from jpeg_tpu_torch.utils.metrics import default_metrics


@pytest.fixture(scope="module", autouse=True)
def library():
    """Build (or reuse) the port's native library once per module."""
    assert native.available()


def _encoder(ns: int, header: str) -> jt.DeviceEncoder:
    enc = jt.DeviceEncoder.for_config(
        16, 32, 3, EncodeParams(h=2, v=2, optimize=False,
                                restart_interval=1, exact=False),
        device="cpu")
    if header == "per_batch":
        hist = np.random.default_rng(5).integers(
            0, 50, size=(len(enc.table_keys), 256)).astype(np.int32)
        enc = dataclasses.replace(enc, header=enc.optimized_tables(hist)[2])
    return dataclasses.replace(enc, n_segments=ns)


def _headers(enc: jt.DeviceEncoder, header: str, frames: int):
    """The encoder's header, or with "per_frame" one a frame from seeded
    per-frame histograms (``frame_tables``): headers of other lengths."""
    if header != "per_frame":
        return enc.header
    hist = np.random.default_rng(9).integers(
        0, 3, size=(frames * len(enc.table_keys), 256)).astype(np.int32)
    return enc.frame_tables(hist)[2]


def _words(bits: np.ndarray, kind: str, rng) -> np.ndarray:
    n = int(((bits + 31) // 32).sum())
    if kind == "ff":
        return np.full(n, 0xFFFFFFFF, np.uint32)
    words = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(
        np.uint32)
    if kind == "pad_to_ff":
        # Each segment's last byte reads 0xFF once its pad bits are set:
        # 0xFF with its low pad bits cleared.
        nbytes, wbase = (bits + 7) // 8, np.cumsum((bits + 31) // 32)
        for s in np.flatnonzero(bits):
            last = wbase[s] - (bits[s] + 31) // 32 + (nbytes[s] - 1) // 4
            shift = 24 - 8 * ((nbytes[s] - 1) % 4)
            byte = 0xFF & ~((1 << int(8 * nbytes[s] - bits[s])) - 1)
            words[last] = (int(words[last]) & ~(0xFF << shift)
                           | byte << shift) & 0xFFFFFFFF
    return words


# name -> (bits a segment: one value or a pool to draw from, word kind,
# segments a frame, frames, header)
CASES = {
    "bits0": ((0,), "random", 9, 8, "default"),
    "bits1": ((1,), "random", 9, 8, "default"),
    "bits8": ((8,), "random", 9, 8, "default"),
    "bits31": ((31,), "random", 9, 8, "default"),
    "bits32": ((32,), "random", 9, 8, "default"),
    "bits33": ((33,), "random", 9, 8, "default"),
    "mixed_with_empty": ((0, 1, 7, 8, 9, 25, 30, 31, 32, 33, 64, 100),
                         "random", 9, 8, "default"),
    "pad_to_ff": ((3, 5, 15, 23, 31, 37, 63), "pad_to_ff", 9, 8,
                  "default"),
    "words_all_ff": ((1, 8, 9, 31, 32, 33, 100), "ff", 9, 8, "default"),
    "one_segment_a_frame": ((600, 1000, 4000), "random", 1, 8, "default"),
    "rst_wraps_one_frame": ((5, 64, 700), "random", 17, 1, "default"),
    "rst_wraps": ((5, 64, 700), "random", 17, 8, "per_batch"),
    "per_batch_header": ((1, 30, 600, 1000), "random", 9, 1, "per_batch"),
    "frame_sized": ((600, 700, 800, 1000), "random", 2040, 1, "default"),
    "per_frame_headers": ((0, 1, 33, 600, 1000), "random", 9, 8,
                          "per_frame"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_native_tail_matches_numpy_tail(case):
    pool, kind, ns, frames, header = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    bits = rng.choice(np.asarray(pool, np.int64), size=frames * ns)
    if case == "mixed_with_empty":
        bits[-2:] = (30, 0)  # an empty last segment after a padded word
    enc = _encoder(ns, header)
    words = _words(bits, kind, rng)
    headers = _headers(enc, header, frames)
    want = enc._finalize_flat_ref(words, bits, frames, headers)
    got = native.finalize_flat_native(words, bits, frames, ns, headers)
    assert got == want
    if isinstance(headers, bytes):
        headers = [headers] * frames
    else:
        assert len(set(headers)) == frames and len(set(map(len, headers))) > 1
    assert all(f.startswith(h) and f.endswith(b"\xff\xd9")
               for f, h in zip(got, headers))
    for f, h in zip(got, headers):  # a 0xFF in the data is followed by
        body = f[len(h):-2]  # 0x00, RSTn not
        assert [body[i + 1] for i in range(len(body) - 1)
                if body[i] == 0xFF and body[i + 1]] \
            == [0xD0 + (s & 7) for s in range(ns - 1)]


@pytest.mark.parametrize("case", ["without_library", "failed_build_on_card"])
def test_finalize_flat_takes_the_native_tail(monkeypatch, case):
    """Without the library, ``encode_batch`` finishes every chunk with the
    NumPy tail, counted as such, with the native run's bytes; an encoder
    on a card raises instead, with the build's error, tried once."""
    if case == "without_library":
        enc = jt.DeviceEncoder.for_config(
            40, 56, 3, EncodeParams(h=2, v=2, optimize=False,
                                    restart_interval=3, exact=False),
            device="cpu")
        px = torch.from_numpy(np.random.default_rng(2).integers(
            0, 256, (5, 40, 56, 3), dtype=np.uint8))
        with_native = enc.encode_batch(px, chunk=2)
        monkeypatch.setattr(native, "available", lambda: False)
        c = default_metrics.counters
        keys = ("device_encode.native_finalize_chunks",
                "device_encode.python_finalize_chunks")
        before = [c[k] for k in keys]
        assert enc.encode_batch(px, chunk=2) == with_native
        assert [c[k] - b for k, b in zip(keys, before)] == [0, 3]
        return
    builds = []

    def failed_build():
        builds.append(1)
        raise RuntimeError("g++ failed (1):\nencode_tail.cpp: error")

    enc = dataclasses.replace(_encoder(4, "default"),
                              device=torch.device("cuda"))
    bits = np.array([9, 31, 64, 100] * 2, np.int64)
    words = _words(bits, "random", np.random.default_rng(1))
    monkeypatch.setattr(native, "load_library", failed_build)
    native._attempt.cache_clear()
    try:
        with pytest.warns(RuntimeWarning, match="encode_tail.cpp: error"):
            assert not native.available()
        for _ in range(2):
            with pytest.raises(RuntimeError, match="encode_tail.cpp: error"):
                enc._finalize_flat(words, bits, 2)
        assert builds == [1]
    finally:
        native._attempt.cache_clear()


def _raw(words, bits, frames, ns, header, cap, hdr_off=None):
    """``jt_finalize_flat`` with ``header`` for every frame, or with
    ``hdr_off`` [frames + 1] the frames' headers' offsets in it."""
    out = np.zeros(max(cap, 1), np.uint8)
    off = np.zeros(frames + 1, np.int64)
    hdr = np.frombuffer(header, np.uint8)
    p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))  # noqa: E731
    own = None if hdr_off is None else p(np.asarray(hdr_off, np.int64),
                                         ctypes.c_int64)
    return int(native.load_library().lib.jt_finalize_flat(
        p(words, ctypes.c_uint32), words.size, p(bits, ctypes.c_int64),
        frames, ns, p(hdr, ctypes.c_uint8), own, hdr.size,
        p(out, ctypes.c_uint8), cap, p(off, ctypes.c_int64))), out, off


@pytest.mark.parametrize("fault", ["capacity", "capacity_exact",
                                   "short_words", "negative_bits",
                                   "negative_header"])
def test_native_tail_refuses(fault):
    """-1 below the worst-case capacity (the headers + 2 * live bytes +
    2 * segments), -2 for a stream short of words, a negative bit count
    or a negative header length; the worst case itself is accepted."""
    frames, ns, header = 2, 3, b"\xff\xd8header"
    bits = np.array([8, 31, 33, 1, 0, 64], np.int64)
    words = _words(bits, "ff", None)
    live = int(((bits + 7) // 8).sum())
    cap = frames * len(header) + 2 * live + 2 * bits.size
    if fault == "capacity":
        assert _raw(words, bits, frames, ns, header, cap - 1)[0] == -1
    elif fault == "capacity_exact":
        n, out, off = _raw(words, bits, frames, ns, header, cap)
        assert n == cap == off[-1]  # all 0xFF: the worst case is met
        enc = dataclasses.replace(_encoder(ns, "default"), header=header)
        assert [out[off[f]:off[f + 1]].tobytes() for f in range(frames)] \
            == enc._finalize_flat_ref(words, bits, frames)
    elif fault == "short_words":
        assert _raw(words[:-1], bits, frames, ns, header, cap)[0] == -2
        with pytest.raises(ValueError, match="refused"):
            native.finalize_flat_native(words[:-1], bits, frames, ns, header)
    elif fault == "negative_bits":
        bits[2] = -1
        assert _raw(words, bits, frames, ns, header, cap)[0] == -2
    else:
        hdr_off = np.asarray([0, len(header), 3], np.int64)
        assert _raw(words, bits, frames, ns, header, cap, hdr_off)[0] == -2
