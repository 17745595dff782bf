"""PyTorch port: the prep's run walk against the byte-at-a-time loops.

``native/ecs_walk.cpp`` unstuffs and packs a frame's restart segments
one 0xFF-free run at a time; ``jt_walk_ecs_flat`` keeps the contract of
``native/scanner.cpp``'s ``jt_prep_ecs_flat``, and ``jt_walk_ecs_rows``
that of ``jt_prep_ecs_rows`` with a row map and of ``jt_prep_ecs`` with
none; the old loops stay bound in the library as the oracle.
Each case runs both on the same input into buffers of the same start
and compares the return code, ``used_words`` and ``end_off`` (set to a
sentinel before the call, so an untouched one compares too) and, where
the code is a segment count, ``starts``, ``lens`` and the whole output
buffer, which starts dirty: the segments' words, zeros past each
segment's last byte in its last word, and the words neither walk may
touch.
Held on every frame of the committed corpus, on seeded mutations of
short frames (byte flips; inserted 0xFF, FF 00 and fill runs before a
RST; truncation at every offset), on hand-made segments (FF 00 at each
byte of a word, empty segments, segments that end on a word) and on each
fallback code made on purpose.
"""

import ctypes
from pathlib import Path

import numpy as np
import pytest

from jpeg_tpu_torch import native
from jpeg_tpu_torch.mjpeg import split_stream
from jpeg_tpu_torch.models.device_decode import _first_ecs_byte

CORPUS = Path(__file__).resolve().parent / "data" / "torch_port"
STREAMS = sorted(p.stem for p in CORPUS.glob("*.mjpeg"))
# (old loop, run walk) for each of the three contracts; "ident" is the
# rows walk with no row map.
KINDS = {"flat": ("jt_prep_ecs_flat", "jt_walk_ecs_flat"),
         "rows": ("jt_prep_ecs_rows", "jt_walk_ecs_rows"),
         "ident": ("jt_prep_ecs", "jt_walk_ecs_rows")}
SENTINEL = -7
DIRT = 0xA5C3E1F7  # the output's words before a walk
EOI = b"\xff\xd9"


@pytest.fixture(scope="module")
def lib():
    return native.load_library().lib


def frames_of(name):
    return split_stream((CORPUS / f"{name}.mjpeg").read_bytes())


def _p(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def _call(lib, fn, kind, data, start, max_rows, cap, row_map):
    """One walk -> (rc, used_words, end_off, starts, lens, out)."""
    buf = np.frombuffer(bytes(data), np.uint8)
    lens = np.zeros(max(max_rows, 1), np.int32)
    starts = np.zeros(max(max_rows, 1), np.int32)
    used = ctypes.c_int64(SENTINEL)
    end = ctypes.c_int64(SENTINEL)
    head = (_p(buf, ctypes.c_uint8), buf.size, start)
    if kind == "flat":
        out = np.full(max(cap, 1), DIRT, np.uint32)
        rc = getattr(lib, fn)(*head, _p(out, ctypes.c_uint32), cap,
                              _p(starts, ctypes.c_int32),
                              _p(lens, ctypes.c_int32), max_rows,
                              ctypes.byref(used), ctypes.byref(end))
    else:
        rows = max_rows if row_map is None else int(row_map.max()) + 1
        out = np.full((max(rows, 1), cap), DIRT, np.uint32)
        if fn.endswith("_rows"):
            rc = getattr(lib, fn)(*head, _p(out, ctypes.c_uint32), cap,
                                  None if row_map is None
                                  else _p(row_map, ctypes.c_int32),
                                  max_rows, _p(lens, ctypes.c_int32),
                                  ctypes.byref(end))
        else:
            rc = getattr(lib, fn)(*head, _p(out, ctypes.c_uint32), cap,
                                  max_rows, _p(lens, ctypes.c_int32),
                                  ctypes.byref(end))
    return rc, used.value, end.value, starts, lens, out


def compare(lib, kind, data, start=0, max_rows=64, cap=None, seed=0):
    """Both walks of ``data`` from ``start`` equal -> the return code.
    ``cap`` is words: the flat buffer's, or a row's; by default room for
    the input.  The "rows" contract takes a seeded permutation of the
    rows as its map."""
    if cap is None:
        cap = (len(data) // 4 + max_rows + 2) if kind == "flat" \
            else (len(data) + 3) // 4 + 1
    row_map = None
    if kind == "rows":
        row_map = np.random.default_rng(seed).permutation(
            max(max_rows, 1)).astype(np.int32)
    old_fn, new_fn = KINDS[kind]
    old = _call(lib, old_fn, kind, data, start, max_rows, cap, row_map)
    new = _call(lib, new_fn, kind, data, start, max_rows, cap, row_map)
    assert new[:3] == old[:3], (kind, new[:3], old[:3])
    rc = old[0]
    if rc > 0:
        np.testing.assert_array_equal(new[4][:rc], old[4][:rc])
        if kind == "flat":
            np.testing.assert_array_equal(new[3][:rc], old[3][:rc])
        np.testing.assert_array_equal(new[5], old[5])
    return rc


def _segments(data: bytes, start: int) -> int:
    return data.count(b"\xff", start) + 1  # markers bound the segments


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("name", STREAMS)
def test_corpus_frames(lib, name, kind):
    """Every corpus frame walks to equal words; the single-scan ones are
    taken (multi-scan frames are refused by both at their second
    scan's tables)."""
    taken = 0
    for data in frames_of(name):
        start = _first_ecs_byte(data)
        # The oracle's segment count and longest segment size the rows
        # (a matrix as wide as the frame would not fit in memory).
        rows = _segments(data, start)
        rc, _, _, _, lens, _ = _call(lib, "jt_prep_ecs_flat", "flat", data,
                                     start, rows, len(data), None)
        if rc > 0:
            rows = rc
        cap = (int(lens.max()) + 3) // 4 + 1 if kind != "flat" else None
        assert compare(lib, kind, data, start, rows, cap) == rc
        taken += rc > 0
    if not name.startswith("multiscan"):
        assert taken == len(frames_of(name))


def _short_frames():
    """Short single-scan corpus frames with restart markers."""
    out = []
    for name in ("yuv420_ri2", "short_gray_ri4", "p12_422_ri2"):
        for data in frames_of(name)[:2]:
            out.append((data, _first_ecs_byte(data)))
    return out


def _mutate(how, rng, data: bytes, start: int) -> bytes:
    body = bytearray(data)
    for _ in range(int(rng.integers(1, 4))):
        at = int(rng.integers(start, len(body) + 1))
        if how == "flip":
            if at < len(body):
                body[at] = int(rng.choice([0xFF, 0x00, 0xD0, 0xD9,
                                           rng.integers(256)]))
        elif how == "ff":
            body[at:at] = b"\xff"
        elif how == "ff00":
            body[at:at] = b"\xff\x00"
        elif how == "fill":
            body[at:at] = b"\xff" * int(rng.integers(1, 6)) + \
                bytes([0xD0 + int(rng.integers(8))])
    return bytes(body)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("how", ["flip", "ff", "ff00", "fill"])
def test_seeded_mutations(lib, how, kind):
    rng = np.random.default_rng(["flip", "ff", "ff00", "fill"].index(how))
    codes = set()
    for data, start in _short_frames():
        for seed in range(40):
            bad = _mutate(how, rng, data, start)
            codes.add(compare(lib, kind, bad, start,
                              _segments(bad, start), seed=seed))
    assert -1 in codes and any(c > 0 for c in codes)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_truncation_at_every_offset(lib, kind):
    data, start = _short_frames()[0]
    rows = _segments(data, start)
    codes = [compare(lib, kind, data[:cut], start, rows)
             for cut in range(start, len(data) + 1)]
    assert codes[-1] > 0 and set(codes[:-1]) == {-1}


def _lits(n: int, seed: int = 0) -> bytes:
    """n literal bytes with no 0xFF."""
    return bytes(np.random.default_rng(seed).integers(0, 255, n,
                                                      dtype=np.uint8))


# Hand-made segments (start 0): each a body closed by EOI, with the
# segment count the walk must give.
HAND = {
    **{f"ff00_phase{p}": (_lits(p) + b"\xff\x00" + _lits(9, p) + EOI, 1)
       for p in range(4)},
    **{f"ff00_phase{p}_seg2": (_lits(5) + b"\xff\xd3" + _lits(p, 7)
                               + b"\xff\x00\xff\x00" + _lits(6) + EOI, 2)
       for p in range(4)},
    "adjacent_rst": (b"ab\xff\xd0\xff\xd1\xff\xd2cd" + EOI, 4),
    "rst_first": (b"\xff\xd0abc" + EOI, 2),
    "rst_last": (b"abc\xff\xd7" + EOI, 2),
    "only_eoi": (EOI, 1),
    "word_boundary": (_lits(4) + b"\xff\xd0" + _lits(8) + b"\xff\xd1"
                      + _lits(3) + b"\xff\x00" + EOI, 3),
    "fill_before_rst": (_lits(6) + b"\xff\xff\xff\xd4" + _lits(2)
                        + b"\xff\xff" + EOI, 2),
    "long_run": (_lits(5000) + b"\xff\xd0" + _lits(4097) + EOI, 2),
    "stuffed_only": (b"\xff\x00" * 9 + EOI, 1),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("case", sorted(HAND))
def test_hand_made_segments(lib, case, kind):
    data, segs = HAND[case]
    assert compare(lib, kind, data, 0, 8) == segs


# Each fallback code on purpose: (bytes, max_rows, the code).
REFUSED = {
    "lone_trailing_ff": (_lits(7) + b"\xff", 4, -1),
    "fill_to_the_end": (_lits(7) + b"\xff\xff\xff", 4, -1),
    "dht_mid_scan": (_lits(5) + b"\xff\xc4" + _lits(4) + EOI, 4, -1),
    "com_after_rst": (_lits(5) + b"\xff\xd0\xff\xfe" + EOI, 4, -1),
    "ff_ff00": (_lits(5) + b"\xff\xff\x00" + EOI, 4, -1),
    "no_eoi": (_lits(5) + b"\xff\xd0" + _lits(6), 4, -1),
    "empty": (b"", 4, -1),
    "rows_zero": (_lits(5) + EOI, 0, -3),
    "rows_short": (_lits(5) + b"\xff\xd0" + _lits(3) + b"\xff\xd1" + EOI,
                   2, -3),
    "rows_short_before_bad_marker": (_lits(5) + b"\xff\xd0" + _lits(3)
                                     + b"\xff\xc4" + EOI, 1, -3),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("case", sorted(REFUSED))
def test_each_refusal(lib, case, kind):
    data, rows, code = REFUSED[case]
    assert compare(lib, kind, data, 0, rows) == code


# Capacity: (bytes, each segment's unstuffed bytes, the code at the
# need).  The room is set at the need, then one word short (for 17
# bytes, one byte short): -2 where the first byte past the room falls,
# mid-run or on a stuffed 0xFF, even when a bad marker follows; a lone
# 0xFF at the end of the input is -1 even with the room full (the byte
# after a Python bytes object is 0x00, which a walk that read past the
# input would take for stuffing).
ROOM = {
    "run_partway": (_lits(13) + b"\xff\xd0" + _lits(6) + EOI, [13, 6], 2),
    "word_exact": (_lits(16) + b"\xff\xd0" + _lits(8) + EOI, [16, 8], 2),
    "stuffed_at_edge": (_lits(8) + b"\xff\x00" + b"\xff\xd0" + _lits(2)
                        + EOI, [9, 2], 2),
    "before_bad_marker": (_lits(11) + b"\xff\xc4" + EOI, [11], -1),
    "one_byte_over": (_lits(17) + EOI, [17], 1),
    "lone_ff_when_full": (_lits(8) + b"\xff", [8], -1),
    # Runs longer than a 32-byte step: the room ends inside a step, and
    # on the stuffed 0xFF after two whole steps.
    "long_run_partway": (_lits(77) + b"\xff\xd0" + _lits(40) + EOI,
                         [77, 40], 2),
    "long_stuffed_at_edge": (_lits(64) + b"\xff\x00" + EOI, [65], 1),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("case", sorted(ROOM))
def test_room_at_the_need_and_one_word_short(lib, case, kind):
    data, lens, code = ROOM[case]
    need = [(k + 3) // 4 for k in lens]
    cap = sum(need) if kind == "flat" else max(need)
    assert compare(lib, kind, data, 0, 4, cap) == code
    assert compare(lib, kind, data, 0, 4, cap - 1) == -2
