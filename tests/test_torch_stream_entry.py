"""PyTorch port: the stream entry's native walks against the Python walks.

``mjpeg.split_stream`` cuts a stream with one C++ walk
(``native/stream_entry.cpp``) while the native library is available;
``mjpeg._split_stream_py`` and ``jpeg_tpu.mjpeg.split_stream`` are the
NumPy walk it replaces.  ``DeviceDecoder.for_stream`` parses only the
sample frame's header and takes the segments' lengths from one
``jt_walk_ecs_flat`` walk; a frame that route refuses takes the whole
parse.  Held here on the committed corpus and on hostile streams built
in the test: the same frames, decoders equal field for field, the same
exception where the whole parse raises, and counters that say which
walk ran.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from jpeg_tpu import mjpeg as jmjpeg

from jpeg_tpu_torch import mjpeg, native
from jpeg_tpu_torch.errors import JpegError, UnsupportedError
from jpeg_tpu_torch.models import device_decode
from jpeg_tpu_torch.models.device_decode import DeviceDecoder
from jpeg_tpu_torch.utils.metrics import default_metrics

CORPUS = Path(__file__).resolve().parent / "data" / "torch_port"
STREAMS = sorted(json.loads((CORPUS / "digests.json").read_text()))
ELIGIBLE = ["bench", "yuv420_ri2", "yuv444_ri3", "gray_ri4", "p12_422_ri2"]
GENERAL = ["ineligible_420_ri3", "short_422_ri5", "short_p12_420_ri5",
           "row_420_ri3", "short_gray_ri4", "rstless_420"]
MULTISCAN = ["multiscan_ri4", "multiscan_ri0"]
FIELDS = ("plan", "geom", "ri", "segs_per_frame", "htable_key",
          "qtables_host", "header", "scan_start", "wn", "max_steps",
          "prep_mode", "place_ri")
SPLITS = ("mjpeg.native_splits", "mjpeg.python_splits")
HEADS = ("device_decode.native_for_stream",
         "device_decode.python_for_stream")


@pytest.fixture(scope="module", autouse=True)
def library():
    """Build (or reuse) the port's native library once per module."""
    assert native.available()


def _stream(name: str) -> bytes:
    return (CORPUS / f"{name}.mjpeg").read_bytes()


def _frame(name: str = "yuv420_ri2") -> bytes:
    return jmjpeg.split_stream(_stream(name))[0]


def _counts(keys) -> list:
    return [default_metrics.counters.get(k, 0) for k in keys]


def _counted(keys, fn):
    """-> (fn(), how much each counter of ``keys`` rose)."""
    before = _counts(keys)
    out = fn()
    return out, [b - a for a, b in zip(before, _counts(keys))]


def _split_all_ways(data) -> list:
    """The native split, after checking it against both NumPy walks and
    that it was counted native."""
    got, rose = _counted(SPLITS, lambda: mjpeg.split_stream(data))
    assert rose == [1, 0]
    want = mjpeg._split_stream_py(data)
    assert [bytes(f) for f in got] == [bytes(f) for f in want] == \
        [bytes(f) for f in jmjpeg.split_stream(data)]
    assert [type(f) for f in got] == [type(f) for f in want]
    return got


@pytest.mark.parametrize("name", STREAMS)
def test_native_split_matches_python_on_corpus(name):
    data = _stream(name)
    assert len(_split_all_ways(data)) == len(
        json.loads((CORPUS / "digests.json").read_text())[name])


def _hostile(case: str):
    """A hostile stream for the split: -> (stream, frames it holds)."""
    a, b = _frame("yuv420_ri2"), _frame("gray_ri4")
    body = a[2:]
    if case == "thumbnail":  # an APP1 payload holding a whole JPEG
        app = b"Exif\x00\x00" + b
        seg = b"\xff\xe1" + (len(app) + 2).to_bytes(2, "big") + app
        return a[:2] + seg + body + b, 2
    if case == "fill_bytes":
        return (a[:2] + b"\xff\xff\xff" + body[1:-2] + b"\xff\xff\xd9"
                + b"\xff\xff" + b), 2
    if case == "stray_soi_tem":
        return a[:2] + b"\xff\xd8\xff\x01" + body + b, 2
    if case == "length_under_2":
        return a[:2] + b"\xff\xfe\x00\x01" + body + b, 2
    if case == "garbage_first":
        return b"junk\xff\x00\xff\xd9\xff\xd0\xffx" + a + b, 2
    if case == "truncated_last":
        return a + b + a[: len(a) // 2], 2
    if case == "marker_past_end":
        return a + b + b"\xff\xd8\xff\xe0\x7f", 2
    if case == "lone_trailing_ff":
        return a + b + b"\xff", 2
    if case.startswith("short_"):
        return bytes.fromhex(case[6:]), 0
    if case == "more_than_cap":
        return (a + b"\xff\xd8\xff\xd9") * 40, 80
    if case in ("bytearray", "memoryview"):
        kind = bytearray if case == "bytearray" else memoryview
        return kind(a + b + a), 3
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "thumbnail", "fill_bytes", "stray_soi_tem", "length_under_2",
    "garbage_first", "truncated_last", "marker_past_end", "lone_trailing_ff",
    "short_", "short_ff", "short_ffd8", "short_ffd8ff", "more_than_cap",
    "bytearray", "memoryview"])
def test_native_split_matches_python_on_hostile_streams(case):
    data, frames = _hostile(case)
    assert len(_split_all_ways(data)) == frames


def test_native_split_retries_past_its_first_cap():
    """``jt_split_stream`` refuses a ``cap`` below the frame count (-1);
    ``split_stream_native`` then retries with room for every frame."""
    data = b"\xff\xd8\xff\xd9" * 9
    assert native.split_stream_native(data, cap=9) == \
        native.split_stream_native(data, cap=2) == \
        [(4 * i, 4 * i + 4) for i in range(9)]


def test_split_without_library(monkeypatch):
    data = _stream("yuv420_ri2") + _stream("gray_ri4")
    want = mjpeg.split_stream(data)
    monkeypatch.setattr(native, "available", lambda: False)
    got, rose = _counted(SPLITS, lambda: mjpeg.split_stream(data))
    assert got == want and len(got) == 5
    assert rose == [0, 1]


def _decoder_or_error(frame: bytes):
    try:
        return DeviceDecoder.for_stream(frame, "cpu")
    except JpegError as e:
        return type(e)


def _whole_parse(frame: bytes, monkeypatch):
    """``for_stream`` as it was before the native route: the whole
    parse, counted Python."""
    with monkeypatch.context() as m:
        m.setattr(device_decode, "_native_head", lambda data: None)
        return _counted(HEADS, lambda: _decoder_or_error(frame))


def _assert_same_decoder(got, want):
    if isinstance(want, type):
        assert got is want
        return
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert type(a) is type(b) and a == b, f
    assert torch.equal(got.qtables, want.qtables)


def _rewrite(case: str) -> bytes:
    """A frame the native route refuses, from a ri=2 4:2:0 frame."""
    a = _frame("yuv420_ri2")
    sos = a.index(b"\xff\xda")
    if case == "dnl":
        return a[:-2] + b"\xff\xdc\x00\x04\x00\x10\xff\xd9"
    if case == "surplus_rst":
        return a[:-2] + b"\xff\xd3\x12\x34\xff\xd9"
    if case == "second_scan":
        return a[:-2] + a[sos:]
    if case == "table_after_scan":  # the whole parse keeps the new table
        dqt = a.index(b"\xff\xdb")
        n = int.from_bytes(a[dqt + 2:dqt + 4], "big")
        table = bytearray(a[dqt:dqt + 2 + n])
        table[5:9] = b"\x01\x02\x03\x04"
        return a[:-2] + bytes(table) + b"\xff\xd9"
    if case.startswith("sos_length"):  # the whole parse reads no length
        n = int.from_bytes(a[sos + 2:sos + 4], "big")
        if case == "sos_length_long":  # to the byte after the first RST
            n = a.index(b"\xff\xd0", sos) + 2 - (sos + 2)
        else:
            n -= 1
        return a[:sos + 2] + n.to_bytes(2, "big") + a[sos + 4:]
    if case == "no_eoi":
        return a[:-2]
    if case == "garbage_in_ecs":
        return a[:-2] + b"\xff\xff\x00\x12\xff\xd9"
    raise ValueError(case)


@pytest.mark.parametrize("name", STREAMS)
def test_native_for_stream_matches_whole_parse_on_corpus(name, monkeypatch):
    frame = _frame(name)
    got, rose = _counted(HEADS, lambda: _decoder_or_error(frame))
    want, rose_py = _whole_parse(frame, monkeypatch)
    assert rose_py == [0, 1]
    _assert_same_decoder(got, want)
    if name in ELIGIBLE + GENERAL:
        assert rose == [1, 0]
    if name in MULTISCAN:
        assert rose == [0, 1] and want is UnsupportedError


@pytest.mark.parametrize("case", [
    "dnl", "surplus_rst", "second_scan", "table_after_scan",
    "sos_length_short", "sos_length_long", "no_eoi", "garbage_in_ecs",
    "multiscan_ri4", "multiscan_ri0"])
def test_refused_frames_take_the_whole_parse(case, monkeypatch):
    frame = _frame(case) if case.startswith("multiscan") else _rewrite(case)
    assert device_decode._native_head(frame) is None
    got, rose = _counted(HEADS, lambda: _decoder_or_error(frame))
    want, _ = _whole_parse(frame, monkeypatch)
    assert rose == [0, 1]
    _assert_same_decoder(got, want)


@pytest.mark.parametrize("name", ["yuv420_ri2", "gray_ri4", "p12_422_ri2",
                                  "short_422_ri5", "rstless_420"])
def test_stream_pixels_equal_the_python_walks(name, monkeypatch):
    data = _stream(name)
    (px, splits), heads = _counted(HEADS, lambda: _counted(
        SPLITS, lambda: mjpeg.decode_stream_device(data, "cpu", chunk=2)))
    assert splits == [1, 0] and heads == [1, 0]
    monkeypatch.setattr(mjpeg, "split_stream", mjpeg._split_stream_py)
    monkeypatch.setattr(device_decode, "_native_head", lambda data: None)
    (px_py, splits), heads = _counted(HEADS, lambda: _counted(
        SPLITS, lambda: mjpeg.decode_stream_device(data, "cpu", chunk=2)))
    assert splits == [0, 0] and heads == [0, 1]
    assert torch.equal(px, px_py)
