"""PyTorch port: the RST-less speculative engine (CPU).

On CPU tensors the engine (``jpeg_tpu_torch/entropy/speculative.py``)
runs the plain versions of its kernels (``speculative_torch``: K8 sync,
K9 resolve, K10 final), the functions the CUDA kernels are held to bit
for bit on the card.  Here the engine's coefficients must equal the
serial oracle's (``jpeg_tpu.entropy.serial.decode_scan_serial``) exactly,
on streams ``jpeg_tpu.encode_jpeg`` writes without restart markers:
every sampling, gray, 12-bit, chunk sizes that cut blocks and that give
one row per frame, batches of frames of different coded size.  Around
it: ``mjpeg.decode_stream_device`` and ``decode_frame_rstless`` against
``jpeg_tpu.decode_jpeg`` (pixels within +-1: the float32 IDCT sums in
another order), ``decode_jpeg(entropy="speculative")`` against the
serial backend, damaged streams, and the three faults ADVICE.md records
against the JAX engine.  K8's plain version, which walks only each row's
distinct decodes past the strip, is held integer for integer to a walk of
every variant from its row's first bit (``sync_every_variant``).

The JAX package's own device path (``models.device_decode.
decode_stream_rstless``) is not run here: its first call on one 192x128
4:2:0 frame takes about 110 s on the CPU, nearly all of it compiling,
past this file's ~60 s budget.  Its semantics are the serial oracle's,
which every test here holds the port to.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jpeg_tpu
from jpeg_tpu.encoder import EncodeParams, encode_jpeg
from jpeg_tpu.entropy.serial import decode_scan_serial
from jpeg_tpu.format.parse import parse_codestream as jax_parse
from jpeg_tpu.format.parse import unstuff as jax_unstuff
from jpeg_tpu.tables import derive_table

import jpeg_tpu_torch as jt
from jpeg_tpu_torch.entropy import speculative, speculative_cuda
from jpeg_tpu_torch.entropy import speculative_torch as st
from jpeg_tpu_torch.entropy.lockstep_torch import _cached_plan
from jpeg_tpu_torch.format.parse import parse_codestream, unstuff
from jpeg_tpu_torch.utils.metrics import default_metrics
from refbin import make_pgm, make_ppm

CPU = torch.device("cpu")
# name -> (image, sampling): every scan shape the engine takes
IMAGES = {
    "420": (lambda s: make_ppm(96, 64, seed=s), dict(h=2, v=2)),
    "422": (lambda s: make_ppm(80, 48, seed=s), dict(h=2, v=1)),
    "444": (lambda s: make_ppm(64, 40, seed=s), dict(h=1, v=1)),
    "gray": (lambda s: make_pgm(72, 56, seed=s), {}),
    "gray12": (lambda s: make_pgm(64, 48, seed=s, maxval=4095), {}),
}
# (chunk bytes, strip bytes): short rows; 16-byte rows, which cut blocks;
# one row per frame (the default chunk runs in the stream tests)
CHUNKS = [(64, 16), (16, 4), (1 << 20, 128)]


def rstless(name, seed=1, quality=75):
    img, kw = IMAGES[name]
    return encode_jpeg(img(seed), EncodeParams(
        quality=quality, restart_interval=0, optimize=False, **kw))


def oracle(data, segment=None):
    """The serial oracle's planes of a one-scan frame, concatenated in
    component order ([total_blocks, 64] int32), and its MCU count."""
    cs = jax_parse(data)
    scan = cs.scans[0]
    tables = {k: derive_table(s) for k, s in scan.htables.items()}
    planes = {c.cid: np.zeros((c.n_blocks, 64), np.int32)
              for c in cs.geometry.components}
    if segment is None:
        s, e = scan.ecs_ranges[0]
        segment = jax_unstuff(data[s:e])
    n = decode_scan_serial(cs.geometry, scan.info, tables, [segment], planes)
    return np.concatenate([planes[c.cid] for c in cs.geometry.components]), n


def plan_of(data):
    cs = parse_codestream(data)
    scan = cs.scans[0]
    plan = _cached_plan(cs.geometry, scan.info,
                        tuple(sorted(scan.htables.items())))
    return plan, sum(c.n_blocks for c in cs.geometry.components)


def segment_of(data):
    s, e = parse_codestream(data).scans[0].ecs_ranges[0]
    return unstuff(data[s:e])


def engine(frames, chunk_bytes=speculative.CHUNK_BYTES,
           strip_bytes=speculative.STRIP_BYTES, segments=None,
           piece_bytes=None):
    plan, tb = plan_of(frames[0])
    segs = segments or [segment_of(f) for f in frames]
    return speculative.speculative_core_batch(plan, tb, segs, CPU,
                                              chunk_bytes, strip_bytes,
                                              piece_bytes)


def counter(name):
    return default_metrics.counters.get(name, 0)


@pytest.mark.parametrize("chunk", CHUNKS, ids=lambda c: f"chunk{c[0]}")
@pytest.mark.parametrize("name", list(IMAGES))
def test_engine_matches_serial_oracle(name, chunk):
    data = rstless(name)
    before = counter("speculative.fallbacks")
    res = engine([data], *chunk)
    assert res is not None and counter("speculative.fallbacks") == before
    coeffs, n_use = res
    want, _ = oracle(data)
    np.testing.assert_array_equal(coeffs.numpy(), want)
    assert n_use == [want.shape[0]]


@pytest.mark.parametrize("chunk", [(64, 16), (16, 4)],
                         ids=lambda c: f"chunk{c[0]}")
def test_batch_of_different_frames(chunk):
    """Three frames of other content and coded size in one batch: each
    frame's DC chain starts anew and its rows stay its own."""
    frames = [rstless("420", seed=s, quality=q)
              for s, q in ((3, 50), (4, 95), (5, 75))]
    assert len({len(f) for f in frames}) == 3
    coeffs, n_use = engine(frames, *chunk)
    tb = coeffs.shape[0] // 3
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(coeffs[i * tb:(i + 1) * tb].numpy(),
                                      oracle(f)[0])


def test_stages_hold_their_contracts():
    """K8's links and marks on an intact frame, K9's rows, stats and
    pieces, and K10's row checks."""
    data = rstless("420")
    plan, tb = plan_of(data)
    words, nbits, rows = speculative.prepare_batch([segment_of(data)], CPU,
                                                   64)
    links, member, marks = speculative_cuda.sync(plan, words, nbits, rows,
                                                 512, 128, 128)
    bpm = plan.blocks_per_mcu
    assert links.shape == (rows.R * bpm, st.NCOL)
    assert member.shape == (rows.R * 128 * bpm,)
    assert marks.shape == (rows.R * bpm, 3, st.MCOL)  # 4 pieces a row
    # the frame's last row ends at the segment's end, every other row links
    # or misses; variant 0 of row 0 starts at the true origin
    assert int(links[(rows.R - 1) * bpm, st.L_ST]) == st.ST_END
    assert set(links[:(rows.R - 1) * bpm, st.L_ST].tolist()) <= {
        st.ST_LINK, st.ST_MISS, st.ST_END}
    res = speculative_cuda.resolve(plan, words, nbits, rows, links, member,
                                   marks, 512, 128, 128, rows.R + 1)
    row = res.row
    assert int(row[st.R_BIT, 0]) == 0 and int(row[st.R_SLOT, 0]) == 0
    assert (row[st.R_STATE] == st.SETTLED).all()
    assert res.frame.shape == (1, st.SCOL)
    assert int(res.frame[0, st.S_BAD]) == 0
    assert int(res.frame[0, st.S_UNRESOLVED]) == 0
    assert int(row[st.R_NBLK].sum()) >= plan.n_mcus * bpm
    assert res.pieces.shape == (rows.R * 4, st.PCOL)
    assert int(res.pieces[:, st.P_N].sum()) == int(row[st.R_NBLK].sum())
    coeffs, ok = speculative_cuda.final(plan, words, nbits, rows, res.pieces,
                                        tb)
    assert bool((ok == 1).all())
    np.testing.assert_array_equal(coeffs.numpy(), oracle(data)[0])
    # the wrappers launch or raise on a device that is neither
    with pytest.raises(ValueError, match="device"):
        speculative_cuda.sync(plan, words.to("meta"), nbits.to("meta"),
                              rows, 512, 128, 128)


def test_stream_pixels_and_routing():
    """Frames over 8,192 bytes decode on the engine, one batch per chunk,
    with no host frame; small RST-less frames keep the one-lane path."""
    params = EncodeParams(h=2, v=2, quality=95, restart_interval=0,
                          optimize=False, exact=False)
    big = [encode_jpeg(make_ppm(192, 128, seed=s), params) for s in (1, 2, 3)]
    assert min(map(len, big)) > jt.mjpeg.RSTLESS_DEVICE_MAX_BYTES
    host = counter("mjpeg.rstless_host_frames")
    batches = counter("speculative.batches")
    px = jt.mjpeg.decode_stream_device(b"".join(big), "cpu", chunk=2)
    assert counter("mjpeg.rstless_host_frames") == host
    assert counter("speculative.batches") == batches + 2
    for i, f in enumerate(big):
        want = jpeg_tpu.decode_jpeg(f, exact=False).pixels()
        assert np.abs(px[i].numpy().astype(int) - want).max() <= 1
    one = jt.decode_frame_rstless(big[1], "cpu")
    assert torch.equal(one, px[1])
    assert torch.equal(jt.warm_stream_device(b"".join(big[:1]), "cpu")[0],
                       px[0])
    with pytest.raises(jt.UnsupportedError, match="restart"):
        jt.decode_frame_rstless(
            encode_jpeg(make_ppm(64, 32, seed=1),
                        EncodeParams(restart_interval=2)), "cpu")


def test_decode_jpeg_speculative_backend():
    for name in ("420", "gray12"):
        data = rstless(name, seed=7)
        got = jt.decode_jpeg(data, "cpu", exact=True, entropy="speculative")
        want = jpeg_tpu.decode_jpeg(data, exact=True, entropy="serial")
        assert got.to_pnm() == want.to_pnm()
    # a scan with restart markers routes to the lockstep engine
    ri = encode_jpeg(make_ppm(64, 48, seed=2), EncodeParams(restart_interval=3))
    batches = counter("speculative.batches")
    cs, planes = jt.decode_coefficients(ri, entropy="speculative",
                                        device="cpu")
    assert counter("speculative.batches") == batches
    _, want = jpeg_tpu.decode_coefficients(ri, entropy="serial")
    for cid in want:
        np.testing.assert_array_equal(planes[cid], want[cid])
    with pytest.raises(ValueError, match="device"):
        jt.decode_coefficients(ri, entropy="speculative")


def test_damaged_streams():
    """A damaged segment decodes to the serial oracle's coefficients when
    the oracle still decodes every MCU; otherwise the engine refuses it and
    counts the refusal -- and the API's serial fallback gives the
    oracle's result."""
    data = rstless("420", seed=9)
    seg = segment_of(data)
    rng = np.random.default_rng(0)
    kinds = {"equal": 0, "refused": 0}
    for trial in range(8):
        bad = seg.copy()
        if trial < 2:
            bad = bad[: bad.size * (trial + 1) // 3]  # cut short
        else:
            for p in rng.integers(0, bad.size * 8, 3):
                bad[p >> 3] ^= np.uint8(0x80 >> (p & 7))
        want, n = oracle(data, bad)
        before = counter("speculative.fallbacks")
        res = engine([data], 64, 16, segments=[bad])
        plan, _ = plan_of(data)
        if res is None:
            kinds["refused"] += 1
            assert counter("speculative.fallbacks") == before + 1
            assert n < plan.n_mcus  # refused only short of the MCU count
        else:
            kinds["equal"] += 1
            assert n >= plan.n_mcus
            np.testing.assert_array_equal(res[0].numpy(), want)
    assert kinds["refused"] >= 2  # the cut ones at least
    cut = data[:len(data) // 2] + b"\xff\xd9"
    got = jt.decode_coefficients(cut, entropy="speculative", device="cpu")[1]
    _, want = jpeg_tpu.decode_coefficients(cut, entropy="serial")
    for cid in want:
        np.testing.assert_array_equal(got[cid], want[cid])


def test_many_rows_missing_in_the_first_round():
    """ADVICE: the JAX engine's fused recovery re-probes at most
    min(256, R) rows a round.  Here every row the first walk cannot
    settle is re-decoded in that round: 300 frames whose second row
    misses its link (a 1-byte strip) resolve in one round, exactly, with
    no fallback."""
    frames = [rstless("gray", seed=s) for s in range(4)] * 75
    plan, tb = plan_of(frames[0])
    segs = [segment_of(f) for f in frames]
    chunk = -(-max(s.size for s in segs) // 2)  # two rows a frame
    words, nbits, rows = speculative.prepare_batch(segs, CPU, chunk)
    links, _, _ = speculative_cuda.sync(plan, words, nbits, rows, chunk * 8,
                                        8, chunk * 8)
    ovr = torch.zeros(rows.R, st.OCOL, dtype=torch.int32)
    first = st.walk_ref(links, ovr, rows, plan.blocks_per_mcu, chunk * 8)
    assert int(first[-1]) > 256  # RECOVER rows of the first walk
    before = counter("speculative.fallbacks")
    rounds = counter("speculative.resolve_rounds")
    coeffs, _ = engine(frames, chunk, 1)
    assert counter("speculative.fallbacks") == before
    assert counter("speculative.resolve_rounds") - rounds == 1
    for i in range(4):
        np.testing.assert_array_equal(coeffs[i * tb:(i + 1) * tb].numpy(),
                                      oracle(frames[i])[0])


def test_mispredicts_are_counted():
    """ADVICE: the JAX engine's optimistic_mispredicts never counts on its
    fused (default) path.  The port's engine has one path; a batch whose
    optimistic continuation guesses wrong counts it and still decodes
    exactly."""
    data = rstless("422", seed=2)
    before = counter("speculative.mispredicts")
    coeffs, _ = engine([data], 32, 4)
    assert counter("speculative.mispredicts") > before
    np.testing.assert_array_equal(coeffs.numpy(), oracle(data)[0])


@pytest.mark.parametrize("chunk,strip", [(512, 1024), (0, 0), (64, 0),
                                         (2 << 20, 128), (8192, 8192),
                                         (64.0, 16), (True, 1),
                                         (64, (16, 0)), (64, (16, 65)),
                                         (64, (16, 16.0)), (64, (16, True)),
                                         (1 << 20, (128, 8))])
def test_capacity_out_of_range_raises(chunk, strip):
    """ADVICE: the JAX engine reads TCAP/HCAP from the environment without
    validation.  The port has no such knob: its sizes are constants, and
    a size out of range raises -- a strip given as (strip, piece) holds a
    piece size: 0, longer than the row, not an int, or more than
    MAX_PIECES pieces a row."""
    strip, piece = strip if isinstance(strip, tuple) else (strip, None)
    with pytest.raises(ValueError):
        speculative.check_capacity(chunk, strip, piece)
    with pytest.raises(ValueError):
        engine([rstless("gray")], chunk, strip, piece_bytes=piece)
    assert speculative.check_capacity(
        speculative.CHUNK_BYTES, speculative.STRIP_BYTES,
        speculative.PIECE_BYTES) == speculative.PIECE_BYTES < \
        speculative.CHUNK_BYTES


# (chunk bytes, strip bytes, piece bytes): 4-byte pieces of 16-byte rows
# and 24-byte pieces of 64-byte rows (a short last piece) cut blocks, on
# every image; one piece per row (as the chunk tests run) on one image
PIECES = [(16, 4, 4), (64, 16, 24), (64, 16, 64)]
PIECE_CASES = [pytest.param(name, c, id=f"{name}-piece{c[2]}of{c[0]}")
               for c in PIECES for name in IMAGES
               if c[2] < c[0] or name == "420"]


@pytest.mark.parametrize("name,chunk", PIECE_CASES)
def test_engine_piece_sizes(name, chunk):
    """K10 decodes pieces of a row; any piece size gives the oracle's
    coefficients."""
    data = rstless(name, seed=4)
    coeffs, n_use = engine([data], *chunk[:2], piece_bytes=chunk[2])
    want, _ = oracle(data)
    np.testing.assert_array_equal(coeffs.numpy(), want)
    assert n_use == [want.shape[0]]


@pytest.mark.parametrize("image,kw", [
    (lambda: make_ppm(90, 60, seed=1), dict(h=2, v=2)),
    (lambda: make_ppm(70, 44, seed=2), dict(h=2, v=1)),
    (lambda: make_ppm(37, 21, seed=3), dict(h=1, v=1)),
    (lambda: make_ppm(40, 40, seed=4), dict(h=1, v=2)),
    (lambda: make_pgm(70, 50, seed=5), {}),
], ids=["420", "422", "444", "h1v2", "gray"])
def test_accepted_frame_places_every_block(image, kw):
    """K10 does not clear its output on the card: it must write every
    block of a frame the engine accepts.  Such a frame decodes its first
    n_mcus * bpm block ordinals, and those place onto the frame's blocks
    one to one, also where the size is not a whole number of MCUs."""
    data = encode_jpeg(image(), EncodeParams(restart_interval=0,
                                             optimize=False, **kw))
    plan, tb = plan_of(data)
    g = torch.arange(plan.n_mcus * plan.blocks_per_mcu)
    dst, valid = st._placement(plan, st._consts(plan, CPU), g,
                               g % plan.blocks_per_mcu, 0, tb)
    assert bool(valid.all())
    assert sorted((dst // 64).tolist()) == list(range(tb))


@pytest.mark.parametrize("name", ["420", "444"])
def test_pieces_tile_rows_at_true_block_starts(name):
    """Every settled row's pieces tile its blocks [g0, g0 + nblk) with no
    gap or overlap, and a piece that does not start at the row's entry
    enters at the block start that a decode of the whole frame as one row
    marks at the same boundary (variant 0 of row 0 is the true decode, so
    its marks are all true)."""
    data = rstless(name, seed=6)
    plan, _ = plan_of(data)
    seg = segment_of(data)
    chunk, strip, piece = 16, 4, 4
    P = chunk // piece
    words, nbits, rows = speculative.prepare_batch([seg], CPU, chunk)
    links, member, marks = speculative_cuda.sync(
        plan, words, nbits, rows, chunk * 8, strip * 8, piece * 8)
    res = speculative_cuda.resolve(plan, words, nbits, rows, links, member,
                                   marks, chunk * 8, strip * 8, piece * 8,
                                   rows.R + 1)
    row = res.row.numpy()
    pieces = res.pieces.numpy().reshape(rows.R, P, st.PCOL)
    assert (row[st.R_STATE] == st.SETTLED).all()
    one = -(-seg.size // piece) * piece  # one row, the same boundaries
    w1, n1, r1 = speculative.prepare_batch([seg], CPU, one)
    true = speculative_cuda.sync(plan, w1, n1, r1, one * 8, strip * 8,
                                 piece * 8)[2].numpy()[0]
    cut = 0
    for q in range(rows.R):
        ps, g0 = pieces[q], row[st.R_G0, q]
        assert (ps[:, st.P_N] >= 0).all()
        assert ps[:, st.P_N].sum() == row[st.R_NBLK, q]
        starts = g0 + np.concatenate([[0], np.cumsum(ps[:-1, st.P_N])])
        used = ps[:, st.P_N] > 0
        np.testing.assert_array_equal(ps[used, st.P_G], starts[used])
        for j in np.flatnonzero(used):
            got = tuple(ps[j, [st.P_BIT, st.P_SLOT, st.P_G]])
            if ps[j, st.P_G] == g0:
                assert got[:2] == (row[st.R_BIT, q], row[st.R_SLOT, q])
            else:
                cut += 1
                assert got == tuple(true[q * P + j - 1])
    assert cut > rows.R  # most rows hold more than one piece
    assert row[st.R_NBLK].sum() >= plan.n_mcus * plan.blocks_per_mcu


def global_rounds(plan, words, nbits, rows, links, member, marks, cb, sb, pb,
                  max_rounds):
    """The round loop as one batch-wide loop (one read of the RECOVER rows
    a walk): -> (last walk, (rounds, recovery rows, mispredicts)), or
    (None, ...) at ``max_rounds``."""
    bpm = plan.blocks_per_mcu
    lk = links.numpy()
    marks8 = marks.numpy()
    ovr = np.zeros((rows.R, st.OCOL), np.int64)
    ovr_marks = np.zeros((rows.R, -(-cb // pb) - 1, st.MCOL), np.int64)
    first, rounds, rec = None, 0, 0
    while True:
        w = st.walk_frames(lk, ovr, rows, bpm, cb)
        first = first if first is not None else w
        n = int(w["nrec"].sum())
        if n == 0:
            break
        rounds, rec = rounds + 1, rec + n
        if rounds >= max_rounds:
            return None, (rounds, rec, 0)
        st.recover_ref(plan, words, nbits, rows, member, links,
                       torch.from_numpy(marks8), w,
                       w["state"] == st.RECOVER, ovr, ovr_marks, cb, sb, pb)
    mis = int(((first["state"] == st.SETTLED) & (
        (first["f_bit"] != w["f_bit"]) | (first["f_slot"] != w["f_slot"])))
        .sum()) if rounds else 0
    return w, (rounds, rec, mis)


@pytest.mark.parametrize("case", [
    ("422", (2,), 32, 4), ("420", (3, 4, 5), 16, 4), ("gray", (0, 1, 2), 0, 1)
], ids=["mispredicts", "three_frames", "two_rows"])
def test_resolve_stats_equal_the_batch_round_loop(case):
    """Per-frame rounds on the card (one CTA per frame) give the batch the
    same stats as one batch-wide loop: rounds the most of any frame,
    recovery rows and mispredicts summed; and the same rows."""
    name, seeds, chunk, strip = case
    frames = [rstless(name, seed=s) for s in seeds]
    plan, _ = plan_of(frames[0])
    segs = [segment_of(f) for f in frames]
    chunk = chunk or -(-max(s.size for s in segs) // 2)
    words, nbits, rows = speculative.prepare_batch(segs, CPU, chunk)
    cb, sb, pb = chunk * 8, strip * 8, 4 * 8
    links, member, marks = speculative_cuda.sync(plan, words, nbits, rows,
                                                 cb, sb, pb)
    res = speculative_cuda.resolve(plan, words, nbits, rows, links, member,
                                   marks, cb, sb, pb, rows.R + 1)
    w, (rounds, rec, mis) = global_rounds(plan, words, nbits, rows, links,
                                          member, marks, cb, sb, pb,
                                          rows.R + 1)
    fs = res.frame.numpy()
    assert rec > 0
    assert (int(fs[:, st.S_ROUNDS].max()), int(fs[:, st.S_RECOVERY].sum()),
            int(fs[:, st.S_MISPREDICTS].sum())) == (rounds, rec, mis)
    assert not fs[:, st.S_UNRESOLVED].any()
    for i, key in enumerate(("f_bit", "f_slot", "nblk", "state")):
        np.testing.assert_array_equal(res.row[i].numpy(), w[key])


def test_unresolved_batch_is_refused(monkeypatch):
    """A batch whose frames reach max_rounds is refused as ``unresolved``,
    counted with its rounds, from the one read of the frame checks: K10
    runs on it (its unsettled rows hold no blocks)."""
    data = rstless("422", seed=2)
    resolve = speculative_cuda.resolve
    finals = []
    monkeypatch.setattr(speculative_cuda, "resolve",
                        lambda *a: resolve(*a[:-1], 1))
    monkeypatch.setattr(speculative_cuda, "final", lambda *a: finals.append(
        st.final_ref(*a)) or finals[-1])
    before = {k: counter(k) for k in (
        "speculative.fallbacks", "speculative.fallback[unresolved]",
        "speculative.resolve_rounds", "speculative.recovery_rows")}
    assert engine([data], 32, 4) is None
    assert counter("speculative.fallbacks") == \
        before["speculative.fallbacks"] + 1
    assert counter("speculative.fallback[unresolved]") == \
        before["speculative.fallback[unresolved]"] + 1
    assert counter("speculative.resolve_rounds") == \
        before["speculative.resolve_rounds"] + 1
    assert counter("speculative.recovery_rows") > \
        before["speculative.recovery_rows"]
    assert len(finals) == 1 and finals[0][0].shape[1] == 64


def sync_every_variant(plan, words, nbits, rows, cb, sb, pb):
    """K8 as a walk of every (row, variant) lane, with no grouping: the
    membership of each lane's strip, then each lane's tail walk from its
    row's first bit.  The oracle that the grouped K8 (``sync_ref``, which
    walks only each group's survivor past the strip) must equal."""
    bpm = plan.blocks_per_mcu
    k, w64 = st._consts(plan, CPU), st._words64(words)
    lane = torch.arange(rows.R * bpm)
    row, var = lane // bpm, lane % bpm
    fr = rows.frame[row]
    nb = nbits.to(torch.int64)[fr]
    start = rows.local[row] * cb
    bitpos, slot = start.clone(), var.clone()
    coeff, blk = torch.zeros_like(bitpos), torch.zeros_like(bitpos)
    member = torch.zeros(rows.R * sb * bpm, dtype=torch.int32)
    alive = torch.ones_like(bitpos, dtype=torch.bool)
    while True:
        rel = bitpos - start
        alive = alive & (rel < sb)
        if not bool(alive.any()):
            break
        at = alive & (coeff == 0)
        idx = (row * sb + rel) * bpm + slot
        member.scatter_reduce_(0, idx[at], ((blk << 4 | var) + 1)[at]
                               .to(torch.int32), "amax")
        s = st._symbol(plan, k, w64, fr, bitpos, slot, coeff, nb)
        alive = alive & ~s["dies"]
        bitpos, slot, coeff, blk = st._advance(plan, s, alive, bitpos, slot,
                                               coeff, blk)
    links, marks = st.tail_walk_ref(plan, words, nbits, rows, member, row,
                                    start, var, cb, sb, pb)
    return links, member, marks


def damage_frames(words, nbits, seed):
    """Frame i of the batch damaged the (i % 4)-th way chip_smoke's
    ``damage`` damages lanes: pure noise, cut short, all-zero words over
    its whole row, three flipped bits."""
    rng = np.random.default_rng(seed)
    w = words.numpy().view(np.uint32).copy()
    nb = nbits.numpy().copy()
    for i in range(w.shape[0]):
        kind = i % 4
        if kind == 0:
            w[i] = rng.integers(0, 1 << 32, w.shape[1], dtype=np.uint32)
        elif kind == 1:
            nb[i] = int(nb[i] * rng.random())
        elif kind == 2:
            w[i] = 0
            nb[i] = 32 * w.shape[1]
        else:
            for p in (rng.random(3) * nb[i]).astype(np.int64):
                w[i, p >> 5] ^= np.uint32(1) << np.uint32(31 - (p & 31))
    return torch.from_numpy(w.view(np.int32)), torch.from_numpy(nb)


# (chunk, strip, piece) bytes: the defaults, and sizes whose rows, strips
# and pieces cut blocks (a short last piece at 24 of 64 bytes)
SYNC_SIZES = [(512, 128, 32), (16, 4, 4), (64, 16, 24)]


def _sync_batch(name, chunk, seeds=(1, 2), damaged=False):
    frames = [rstless(name, seed=s) for s in seeds]
    plan, _ = plan_of(frames[0])
    words, nbits, rows = speculative.prepare_batch(
        [segment_of(f) for f in frames], CPU, chunk)
    if damaged:
        words, nbits = damage_frames(words, nbits, 0)
    return plan, words, nbits, rows


@pytest.mark.parametrize("size", SYNC_SIZES,
                         ids=lambda c: "chunk{}-strip{}-piece{}".format(*c))
@pytest.mark.parametrize("name", list(IMAGES))
def test_grouped_sync_equals_every_variant_walk(name, size):
    """K8's plain version, which walks each row's strip once per variant
    and only its distinct decodes past the strip, gives the links,
    membership and marks of a walk of every variant from its row's first
    bit, integer for integer."""
    plan, words, nbits, rows = _sync_batch(name, size[0])
    bits = [8 * x for x in size]
    got = st.sync_ref(plan, words, nbits, rows, *bits)
    want = sync_every_variant(plan, words, nbits, rows, *bits)
    for what, a, b in zip(("links", "member", "marks"), got, want):
        assert torch.equal(a, b), what


@pytest.mark.parametrize("name", list(IMAGES))
def test_grouped_sync_equals_every_variant_walk_damaged(name):
    """The same on four frames damaged four ways, at 64-byte rows with
    16-byte strips and pieces: lanes die in the strip and past it, and
    rows that never resynchronize miss their links."""
    plan, words, nbits, rows = _sync_batch(name, 64, (1, 2, 3, 4), True)
    got = st.sync_ref(plan, words, nbits, rows, 512, 128, 128)
    want = sync_every_variant(plan, words, nbits, rows, 512, 128, 128)
    for what, a, b in zip(("links", "member", "marks"), got, want):
        assert torch.equal(a, b), what
    assert (want[0][:, st.L_ST] == st.ST_END).sum() > rows.F


def test_groups_are_the_lowest_variant_at_each_strip_mark():
    """With pieces as long as the strip, boundary 1's mark of the
    every-variant walk is each lane's strip mark.  Every lane that
    reaches it is grouped with the lowest variant of its row at the same
    (bit, slot), with its own ordinal there; a lane that ends before it
    has no group.  A row whose variants never meet in the strip keeps all
    of them; most rows keep fewer."""
    plan, words, nbits, rows = _sync_batch("420", 16, (1,))
    bpm = plan.blocks_per_mcu
    head = st.sync_head_ref(plan, words, nbits, rows, 128, 8, 8)
    mark = sync_every_variant(plan, words, nbits, rows, 128, 8, 8)[2][:, 0]
    group = head.group.numpy()
    all_kept = fewer = 0
    for q in range(rows.R):
        at = mark[q * bpm:(q + 1) * bpm].numpy()
        reached = at[:, st.M_ORD] != st.MARK_NONE
        keys = [tuple(a[:2]) for a in at]
        for v in range(bpm):
            g = group[q * bpm + v]
            if not reached[v]:
                assert g[st.G_SRV] == -1 and g[st.G_BIT] == -1
                continue
            lowest = min(w for w in range(bpm)
                         if reached[w] and keys[w] == keys[v])
            assert g[st.G_SRV] == lowest
            assert tuple(g[[st.G_BIT, st.G_SLOT, st.G_ORD]]) == tuple(at[v])
        kept = int((group[q * bpm:(q + 1) * bpm, st.G_SRV]
                    == np.arange(bpm)).sum())
        if reached.all() and len(set(keys)) == bpm:
            assert kept == bpm
            all_kept += 1
        fewer += kept < bpm
    assert all_kept > 0 and fewer > 0


def test_survivors_on_bench_content_are_few():
    """On the benchmark's content (a 480 x 272 cut of the 1080p frame,
    4:2:0 q75, no restart markers) at the engine's default sizes, fewer
    than half of the lanes survive their strip: the tail walk decodes
    less than half of what a walk of every variant would."""
    from jpeg_tpu_torch.utils import synth

    px = synth.make_frame(0)[:272, :480]
    ppm = b"P6\n480 272\n255\n" + px.tobytes()
    data = encode_jpeg(ppm, EncodeParams(h=2, v=2, quality=75,
                                         restart_interval=0, optimize=False))
    plan, _ = plan_of(data)
    words, nbits, rows = speculative.prepare_batch([segment_of(data)], CPU)
    bits = [8 * x for x in (speculative.CHUNK_BYTES, speculative.STRIP_BYTES,
                            speculative.PIECE_BYTES)]
    head = st.sync_head_ref(plan, words, nbits, rows, *bits)
    bpm = plan.blocks_per_mcu
    srv = head.group[:, st.G_SRV]
    survivors = int((srv == torch.arange(rows.R * bpm) % bpm).sum())
    assert rows.R > 8 and 0 < survivors < rows.R * bpm // 2


# ---- the native prep (prepare_batch_native) -------------------------------

def stream_frames(name):
    data = (Path(__file__).resolve().parent / "data" / "torch_port"
            / f"{name}.mjpeg").read_bytes()
    return jt.mjpeg.split_stream(data)


def big_frames(seeds=(1, 2, 3), quality=95, restart_interval=0):
    """Frames over ``RSTLESS_DEVICE_MAX_BYTES``, of another coded size
    each and, at one quality, one header up to the scan."""
    params = EncodeParams(h=2, v=2, quality=quality,
                          restart_interval=restart_interval, optimize=False,
                          exact=False)
    return [encode_jpeg(make_ppm(192, 128, seed=s), params) for s in seeds]


def drop_dri(jpeg):
    """The frame without its DRI segment: its restart markers stay in
    the entropy-coded segment."""
    at = jpeg.find(b"\xff\xdd\x00\x04")
    assert 0 <= at < jpeg.find(b"\xff\xda")
    return jpeg[:at] + jpeg[at + 6:]


def rstless_stream(frames, dec=None):
    from jpeg_tpu_torch.models.device_decode import decode_stream_rstless

    return decode_stream_rstless(frames, "cpu", chunk=2, dec=dec)


def outcome(fn):
    """What ``fn()`` ends in: its result, or its exception's type and
    message."""
    try:
        return fn()
    except jt.JpegError as e:
        return type(e), str(e)


def same_outcome(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) \
            and torch.equal(a, b)
    return a == b


PREP_CASES = {
    "rstless_420": lambda: stream_frames("rstless_420"),
    "sizes": lambda: big_frames((4, 5, 6)),
}


@pytest.mark.parametrize("case", list(PREP_CASES))
def test_native_prep_equals_python_prep(case):
    """Words equal to ``pack_words``' over its width and zero past it;
    bit counts and rows equal."""
    frames = PREP_CASES[case]()
    dec = jt.DeviceDecoder.for_stream(frames[0], "cpu")
    assert all(f.startswith(dec.header) for f in frames)
    if case == "sizes":
        assert len({len(f) for f in frames}) == len(frames)
    native = counter("speculative.native_prep_chunks")
    for chunk_bytes in (64, speculative.CHUNK_BYTES):
        got = speculative.prepare_batch_native(frames, dec.scan_start, CPU,
                                               chunk_bytes)
        want = speculative.prepare_batch([segment_of(f) for f in frames],
                                         CPU, chunk_bytes)
        w, wn = got[0], want[0].shape[1]
        assert w.shape[0] == len(frames) and w.shape[1] >= wn
        assert torch.equal(w[:, :wn], want[0])
        assert not w[:, wn:].any()
        assert torch.equal(got[1], want[1])
        np.testing.assert_array_equal(got[2].row0, want[2].row0)
        for name in ("frame", "local", "last", "first", "r0", "frame32"):
            assert torch.equal(getattr(got[2], name), getattr(want[2], name))
    # the coefficients, at the engine's sizes (the loop's last)
    plan, tb = plan_of(frames[0])
    assert torch.equal(speculative.speculative_core(plan, tb, *got)[0],
                       speculative.speculative_core(plan, tb, *want)[0])
    assert counter("speculative.native_prep_chunks") == native + 2


def test_stream_takes_the_native_prep_with_the_library(monkeypatch):
    """``decode_stream_device`` gives the same pixels with and without
    the native library: with it every chunk's prep is native, without it
    every chunk's is the Python prep."""
    frames = big_frames((1, 2, 3))
    stream = b"".join(frames)
    native0 = counter("speculative.native_prep_chunks")
    python0 = counter("speculative.python_prep_chunks")
    px = jt.mjpeg.decode_stream_device(stream, "cpu", chunk=2)
    assert counter("speculative.native_prep_chunks") == native0 + 2
    assert counter("speculative.python_prep_chunks") == python0
    monkeypatch.setattr(jt.native, "available", lambda: False)
    py = jt.mjpeg.decode_stream_device(stream, "cpu", chunk=2)
    assert counter("speculative.native_prep_chunks") == native0 + 2
    assert counter("speculative.python_prep_chunks") == python0 + 2
    assert torch.equal(px, py)


def test_decode_stream_rstless_with_and_without_the_library(monkeypatch):
    """Identical pixels from the native prep, the Python prep with the
    stream's decoder, and the Python prep without one."""
    frames = stream_frames("rstless_420")
    dec = jt.DeviceDecoder.for_stream(frames[0], "cpu")
    native0 = counter("speculative.native_prep_chunks")
    got = rstless_stream(frames, dec)
    assert counter("speculative.native_prep_chunks") == native0 + 1
    monkeypatch.setattr(jt.native, "available", lambda: False)
    assert torch.equal(rstless_stream(frames, dec), got)
    assert torch.equal(rstless_stream(frames), got)
    assert counter("speculative.native_prep_chunks") == native0 + 1


def test_chunk_with_another_dqt_takes_the_python_prep():
    """A frame whose quantization tables differ from the sample's sends
    its whole chunk to the Python prep, which dequantizes it with its
    own tables; the chunk before it stays native."""
    same = big_frames((1, 2, 3))
    other = big_frames((4,), quality=80)[0]
    dec = jt.DeviceDecoder.for_stream(same[0], "cpu")
    assert not other.startswith(dec.header)
    native0 = counter("speculative.native_prep_chunks")
    python0 = counter("speculative.python_prep_chunks")
    px = rstless_stream(same + [other], dec)
    assert counter("speculative.native_prep_chunks") == native0 + 1
    assert counter("speculative.python_prep_chunks") == python0 + 1
    assert torch.equal(px[3], jt.decode_frame_rstless(other, "cpu"))
    want = jpeg_tpu.decode_jpeg(other, exact=False).pixels()
    assert np.abs(px[3].numpy().astype(int) - want).max() <= 1


def test_restart_markers_inside_the_segment_raise_as_before(monkeypatch):
    """A frame with the sample's header whose segment holds RSTn: the
    native pass refuses it, and the Python prep raises as it does
    without the library."""
    a = big_frames((1,))[0]
    rst = drop_dri(big_frames((2,), restart_interval=4)[0])
    dec = jt.DeviceDecoder.for_stream(a, "cpu")
    assert rst.startswith(dec.header)
    assert speculative.prepare_batch_native([a, rst], dec.scan_start,
                                            CPU) is None
    python0 = counter("speculative.python_prep_chunks")
    with pytest.raises(jt.UnsupportedError, match="restart markers"):
        rstless_stream([a, rst], dec)
    monkeypatch.setattr(jt.native, "available", lambda: False)
    with pytest.raises(jt.UnsupportedError, match="restart markers"):
        rstless_stream([a, rst], dec)
    assert counter("speculative.python_prep_chunks") == python0


@pytest.mark.parametrize("cut", ["no_eoi", "eoi"])
def test_truncated_frame_ends_where_the_python_prep_ends(monkeypatch, cut):
    """A frame cut mid-segment, without EOI (the native pass refuses it)
    or closed by one (the engine refuses it): the stream ends as it ends
    with the Python prep, with or without the stream's decoder."""
    a, b = big_frames((1, 2))
    t = b[:len(b) * 2 // 3] + (b"\xff\xd9" if cut == "eoi" else b"")
    dec = jt.DeviceDecoder.for_stream(a, "cpu")
    native = speculative.prepare_batch_native([a, t], dec.scan_start, CPU)
    assert (native is None) == (cut == "no_eoi")
    got = outcome(lambda: rstless_stream([a, t], dec))
    monkeypatch.setattr(jt.native, "available", lambda: False)
    assert same_outcome(got, outcome(lambda: rstless_stream([a, t], dec)))
    assert same_outcome(got, outcome(lambda: rstless_stream([a, t])))
