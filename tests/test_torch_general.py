"""PyTorch port: general-shape restart decode, stream routing (CPU).

Restart streams whose segments do not tile MCU rows (a restart interval
that does not divide the MCU row, a short last segment, no restart
markers at all) take the prefix-sum path.  Its plain version
``decode_segments_general_ref`` -- what the CUDA kernel is held against
on the card -- must equal ``lockstep_jax.decode_scan_device`` integer for
integer, intact and with seeded damage, on multi-frame chunks, and the
NumPy engine ``decode_scan_lockstep`` on intact streams.  Around it:
``DeviceDecoder`` on such streams and on mixed streams against
``jpeg_tpu.decode_coefficients`` (exact) and ``decode_jpeg(exact=False)``
(pixels within +-1: the float32 IDCT sums in another order),
``decode_frame_device`` against jpeg_tpu's (+-1), and
``mjpeg.decode_stream_device``'s RST-less routing.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jpeg_tpu
from jpeg_tpu import mjpeg as jmjpeg
from jpeg_tpu.encoder import EncodeParams, encode_jpeg
from jpeg_tpu.entropy.lockstep import decode_scan_lockstep
from jpeg_tpu.entropy.lockstep_jax import (
    _cached_plan,
    _segments_to_words,
    decode_scan_device,
)
from jpeg_tpu.format.parse import parse_codestream, unstuff
from jpeg_tpu.models.device_decode import decode_frame_device as jax_frame
from jpeg_tpu.tables import derive_table

import jpeg_tpu_torch as jt
from jpeg_tpu_torch.entropy import lockstep_torch, place_cuda
from jpeg_tpu_torch.format.parse import parse_codestream as port_parse
from jpeg_tpu_torch.utils.metrics import default_metrics
from refbin import make_ppm

CORPUS = Path(__file__).resolve().parent / "data" / "torch_port"
DIGESTS = json.loads((CORPUS / "digests.json").read_text())
# Corpus streams of general shape: what each exercises.
GENERAL = {
    "ineligible_420_ri3": "4:2:0, DRI 3 with a short last segment",
    "short_422_ri5": "4:2:2, short last segment",
    "short_p12_420_ri5": "12-bit, short last segment",
    "row_420_ri3": "DRI divides the MCUs but not the MCU row",
    "short_gray_ri4": "grayscale (Ns=1), short last segment",
    "rstless_420": "no restart markers: one lane per frame",
}


def frames_of(name):
    return jmjpeg.split_stream((CORPUS / f"{name}.mjpeg").read_bytes())


def _chunk(name):
    """Three frames of the stream (repeated when it has fewer): the JAX and
    port plans, lane words, frames, segments per frame and blocks."""
    frames = frames_of(name)
    frames = [frames[i % len(frames)] for i in range(3)]
    cs, pcs = parse_codestream(frames[0]), port_parse(frames[0])
    scan, pscan = cs.scans[0], pcs.scans[0]
    plan = _cached_plan(cs.geometry, scan.info,
                        tuple(sorted(scan.htables.items())))
    pplan = lockstep_torch._cached_plan(pcs.geometry, pscan.info,
                                        tuple(sorted(pscan.htables.items())))
    segs = []
    for f in frames:
        segs += [unstuff(f[s:e])
                 for s, e in parse_codestream(f).scans[0].ecs_ranges]
    words, nbits = _segments_to_words(segs)
    tb = sum(c.n_blocks for c in cs.geometry.components)
    spf = len(scan.ecs_ranges)
    return plan, pplan, words, nbits, len(frames), spf, tb, scan


def damage(words, nbits, seed):
    """Seeded damage to lane words, as chip_smoke.py does on the card: of
    every 8 lanes about one becomes noise, one is cut short, one becomes
    all-zero words over its whole row, three get 3 flipped bits each."""
    rng = np.random.default_rng(seed)
    w, nb = words.copy(), nbits.copy()
    S, wn = w.shape
    kind = rng.integers(0, 8, S)
    kind[0] = 0  # at least one noise lane
    noise = kind == 0
    w[noise] = rng.integers(0, 1 << 32, (int(noise.sum()), wn),
                            dtype=np.uint32)
    cut = kind == 1
    nb[cut] = (nb[cut] * rng.random(int(cut.sum()))).astype(nb.dtype)
    zero = kind == 2
    w[zero] = 0
    nb[zero] = 32 * wn
    flip = np.flatnonzero((kind >= 3) & (kind < 6) & (nb > 0))
    for _ in range(3):
        pos = (rng.random(flip.size) * nb[flip]).astype(np.int64)
        w[flip, pos >> 5] ^= np.uint32(1) << (31 - (pos & 31)).astype(
            np.uint32)
    return w, nb


def _port(pplan, words, nbits, frames, spf, tb):
    w_t = torch.from_numpy(np.ascontiguousarray(words).view(np.int32))
    nb_t = torch.from_numpy(nbits.astype(np.int32))
    return w_t, nb_t, place_cuda.decode_segments_general(
        pplan, w_t, nb_t, frames, spf, tb)


@pytest.mark.parametrize("damaged", [False, True], ids=["intact", "damaged"])
@pytest.mark.parametrize("name", list(GENERAL))
def test_general_ref_matches_jax_scatter_path(name, damaged):
    """Integer for integer (coefficients and lane MCU counts) against the
    JAX scan + prefix-sum scatter, on a 3-frame chunk."""
    plan, pplan, words, nbits, frames, spf, tb, scan = _chunk(name)
    assert not place_cuda.region_path(pplan, spf, scan.ri, tb)
    if damaged:
        words, nbits = damage(words, nbits, seed=len(name))
    # One static step bound for both variants (one JAX compile per
    # stream) that no lane can exceed: a symbol costs at least one bit.
    steps = 1 << int(32 * words.shape[1] + 2).bit_length()
    jcounts, jcoeffs, starved = decode_scan_device(
        plan, jnp.asarray(words), jnp.asarray(nbits, jnp.int32), steps, tb,
        frames=frames, segs_per_frame=spf)
    assert not bool(starved)
    before = place_cuda.decode_segments_general.launches
    _, _, (coeffs, counts) = _port(pplan, words, nbits, frames, spf, tb)
    assert place_cuda.decode_segments_general.launches == before
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(coeffs.numpy(), np.asarray(jcoeffs))
    want = np.tile(np.diff(np.r_[0, np.minimum(
        np.arange(1, spf + 1) * (scan.ri or pplan.n_mcus), pplan.n_mcus)]),
        frames)
    if damaged:
        assert (counts.numpy() < want).any()  # the damage killed lanes
    else:
        np.testing.assert_array_equal(counts.numpy(), want)


def test_damage_exercises_the_write_order():
    """On damaged chunks two lanes write some coefficient of a lane
    boundary MCU at different steps, so the rule that the latest emission
    wins (XLA's in-order scatter) decides outputs: reversing the step
    order changes them."""
    changed = 0
    for name in GENERAL:
        _, pplan, words, nbits, frames, spf, tb, _ = _chunk(name)
        words, nbits = damage(words, nbits, seed=len(name))
        w_t = torch.from_numpy(words.view(np.int32))
        counts, key, val, _ = lockstep_torch.scan_lanes(
            pplan, w_t, torch.from_numpy(nbits.astype(np.int32)))
        fwd = place_cuda.place_emissions(pplan, counts, key, val, frames,
                                         spf, tb)
        rev = place_cuda.place_emissions(pplan, counts, key.flip(0),
                                         val.flip(0), frames, spf, tb)
        changed += int((fwd != rev).any())
    assert changed >= 2


def _two_writer_mcus(plan, counts, key, frames, spf, tb):
    """(frame, frame-local MCU) pairs that two lanes write in
    ``place_emissions``: its key decode, block index and in-plane filter."""
    S = counts.shape[0]
    per = counts.to(torch.int64).reshape(frames, spf)
    seg_offset = (per.cumsum(1) - per).reshape(S)
    keys = key.reshape(-1).to(torch.int64)
    upd = torch.nonzero(keys > 0).squeeze(1)
    lane = upd % S
    kk = keys[upd] - 1
    slot = (kk >> 6) & 15
    gmcu = (kk >> 10) + seg_offset[lane]
    c0, c1, c2, po, nb = (torch.from_numpy(a)
                          for a in place_cuda._slot_affinities(plan))
    if plan.interleaved:
        my = gmcu // plan.m_x
        blk = c0[slot] + my * c1[slot] + (gmcu - my * plan.m_x) * c2[slot]
    else:
        blk = c0[slot] + gmcu * c2[slot]
    good = blk - po[slot] < nb[slot]
    lanes = {}
    for f, m, ln in zip((lane // spf)[good].tolist(), gmcu[good].tolist(),
                        lane[good].tolist()):
        lanes.setdefault((f, m), set()).add(ln)
    return {fm for fm, ls in lanes.items() if len(ls) >= 2}


@pytest.mark.parametrize("damaged", [False, True], ids=["intact", "damaged"])
@pytest.mark.parametrize("name", list(GENERAL))
def test_contested_rows_mark_the_two_writer_mcus(name, damaged):
    """``contested_rows``, from the lane MCU counts and the partial flags
    of the plain scan, marks exactly the lane-boundary MCUs that two lanes
    write in ``place_emissions``: none on intact chunks.  The general
    kernel sends only those MCUs through owner keys and resolves them."""
    _, pplan, words, nbits, frames, spf, tb, _ = _chunk(name)
    if damaged:
        words, nbits = damage(words, nbits, seed=len(name))
    counts, key, _, _ = lockstep_torch.scan_lanes(
        pplan, torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(nbits.astype(np.int32)))
    partial = place_cuda.partial_lanes(counts, key)
    rows = place_cuda.contested_rows(counts, partial, frames, spf,
                                     pplan.n_mcus)
    assert rows.dtype == torch.int32 and rows.shape == (frames * (spf + 1),)
    per = counts.to(torch.int64).reshape(frames, spf)
    off = per.cumsum(1) - per
    start = torch.cat([off, off[:, -1:] + per[:, -1:]], 1)
    marked = {(f, int(start[f, r])) for f, r in
              torch.nonzero(rows.reshape(frames, spf + 1)).tolist()}
    want = _two_writer_mcus(pplan, counts, key, frames, spf, tb)
    assert marked == want
    assert len(marked) == int(rows.sum())  # one row per contested MCU
    if not damaged:
        assert not want and not bool(partial.any())


def test_boundary_layout_routes_by_device():
    """The layout rides the count walk now (``_general_layout``: one
    launch with the count walk on a CUDA tensor).  On CPU tensors it runs
    the plain scan, ``lane_layout`` and ``contested_rows`` and counts no
    launch; other devices it cannot launch on raise."""
    _, pplan, words, nbits, frames, spf, tb, _ = _chunk("short_422_ri5")
    words, nbits = damage(words, nbits, seed=3)
    w_t = torch.from_numpy(words.view(np.int32))
    nb_t = torch.from_numpy(nbits.astype(np.int32))
    counts, key, _, _ = lockstep_torch.scan_lanes(pplan, w_t, nb_t)
    partial = place_cuda.partial_lanes(counts, key)
    before = place_cuda.decode_segments_general.launches
    got = place_cuda._general_layout(pplan, w_t, nb_t, frames, spf, tb)
    assert place_cuda.decode_segments_general.launches == before
    want = (counts, partial, *place_cuda.lane_layout(counts, frames, spf),
            place_cuda.contested_rows(counts, partial, frames, spf,
                                      pplan.n_mcus))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    assert bool(got[1].any()) and bool(got[4].any())  # damage contests
    with pytest.raises(ValueError, match="device"):
        place_cuda._general_layout(pplan, w_t.to("meta"), nb_t.to("meta"),
                                   frames, spf, tb)


def test_damage_contests_boundary_mcus():
    """The damaged corpus chunks do contest MCUs, so the test above holds
    the marking on real cases, not only on empty sets."""
    total = 0
    for name in GENERAL:
        _, pplan, words, nbits, frames, spf, tb, _ = _chunk(name)
        words, nbits = damage(words, nbits, seed=len(name))
        counts, key, _, _ = lockstep_torch.scan_lanes(
            pplan, torch.from_numpy(words.view(np.int32)),
            torch.from_numpy(nbits.astype(np.int32)))
        total += len(_two_writer_mcus(pplan, counts, key, frames, spf, tb))
    assert total >= 5


@pytest.mark.parametrize("name", ["ineligible_420_ri3", "short_422_ri5",
                                  "short_gray_ri4"])
def test_general_ref_matches_numpy_lockstep(name):
    """Intact streams: the NumPy engine's scatter-ADD placement agrees."""
    _, pplan, words, nbits, frames, spf, tb, scan = _chunk(name)
    _, _, (coeffs, _) = _port(pplan, words, nbits, frames, spf, tb)
    f = frames_of(name)[0]
    cs = parse_codestream(f)
    sc = cs.scans[0]
    planes = {c.cid: np.zeros((c.n_blocks, 64), np.int32)
              for c in cs.geometry.components}
    tables = {k: derive_table(s) for k, s in sc.htables.items()}
    decode_scan_lockstep(cs.geometry, sc.info, tables,
                         [unstuff(f[s:e]) for s, e in sc.ecs_ranges], planes)
    want = np.concatenate([planes[c.cid] for c in cs.geometry.components])
    np.testing.assert_array_equal(coeffs.numpy()[:tb], want)


def test_wrapper_dispatch_keeps_the_region_rule():
    """Eligible shapes keep the region path (the JAX package's rule,
    RB_MAX included); the rest go to the general path."""
    _, pplan, words, nbits, frames, spf, tb, scan = _chunk(
        "ineligible_420_ri3")
    w_t, nb_t, (coeffs, counts) = _port(pplan, words, nbits, frames, spf, tb)
    got = place_cuda.decode_segments(pplan, w_t, nb_t, frames, spf, scan.ri,
                                     tb)
    assert torch.equal(got[0], coeffs) and torch.equal(got[1], counts)
    with pytest.raises(jt.UnsupportedError, match="general"):
        place_cuda.decode_segments_ref(pplan, w_t, nb_t, frames, spf, scan.ri,
                                       tb)
    with pytest.raises(ValueError, match="device"):
        place_cuda.decode_segments_general(pplan, w_t.to("meta"),
                                           nb_t.to("meta"), frames, spf, tb)
    # 4:2:0 at ri=11 tiles a 22-MCU row, but its region (66 blocks)
    # passes RB_MAX: the JAX package scatters it, and so does the port.
    params = EncodeParams(h=2, v=2, quality=80, restart_interval=11,
                          optimize=False, exact=False)
    frame = encode_jpeg(make_ppm(352, 16, seed=9), params)
    dec = jt.DeviceDecoder.for_stream(frame, "cpu")
    assert dec.plan.m_x % 11 == 0 and dec.segs_per_frame * 11 == 22
    assert not place_cuda.region_path(dec.plan, dec.segs_per_frame, 11,
                                      dec.total_blocks)
    cs, planes = jpeg_tpu.decode_coefficients(frame)
    want = np.concatenate([planes[c.cid] for c in cs.geometry.components])
    np.testing.assert_array_equal(dec.decode_coeffs_batch([frame])[0], want)


@pytest.mark.parametrize("name", list(GENERAL))
def test_device_decoder_general_streams_match_jpeg_tpu(name):
    frames = frames_of(name)
    dec = jt.DeviceDecoder.for_stream(frames[0], "cpu")
    coeffs = dec.decode_coeffs_batch(frames, chunk=2)
    got = [hashlib.sha256(coeffs[i].numpy().tobytes()).hexdigest()
           for i in range(len(frames))]
    assert got == DIGESTS[name]
    px = dec.decode_batch(frames, chunk=2).numpy().astype(int)
    for i, f in enumerate(frames):
        want = jpeg_tpu.decode_jpeg(f, exact=False).pixels()
        assert np.abs(px[i] - want).max() <= 1


def test_mixed_stream_falls_back_per_chunk():
    """Frame 1 carries other Huffman tables: its chunk decodes frame by
    frame on the host path, counted; the others stay on the batch path."""
    frames = frames_of("mixed_420_ri2")
    dec = jt.DeviceDecoder.for_stream(frames[0], "cpu")
    before = default_metrics.counters.get("device_decode.mixed_fallbacks", 0)
    px = dec.decode_batch(frames, chunk=1).numpy().astype(int)
    assert default_metrics.counters["device_decode.mixed_fallbacks"] == \
        before + 1
    for i, f in enumerate(frames):
        want = jpeg_tpu.decode_jpeg(f, exact=False).pixels()
        assert np.abs(px[i] - want).max() <= 1
    # the coefficient path has no per-frame fallback: it raises
    with pytest.raises(jt.UnsupportedError, match="Huffman"):
        dec.decode_coeffs_batch(frames, chunk=1)
    # a chunk of 2 holding frame 1 falls back as a whole
    px2 = dec.decode_batch(frames, chunk=2).numpy()
    np.testing.assert_array_equal(px2[2], px[2].astype(np.uint8))


@pytest.mark.parametrize("name", ["multiscan_ri4", "multiscan_ri0",
                                  "yuv420_ri2", "short_p12_420_ri5"])
def test_decode_frame_device_matches_jax(name):
    frame = frames_of(name)[0]
    got = jt.decode_frame_device(frame, "cpu")
    want = np.asarray(jax_frame(frame))
    assert got.device.type == "cpu" and tuple(got.shape) == want.shape
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


def test_rstless_stream_routing():
    """Small RST-less frames decode on the device path, one lane per
    frame; frames over 8,192 bytes take the speculative engine, one batch
    per chunk, and no frame takes the host rung."""
    small = frames_of("rstless_420")
    before = default_metrics.counters.get("mjpeg.rstless_host_frames", 0)
    batches = default_metrics.counters.get("speculative.batches", 0)
    px = jt.mjpeg.decode_stream_device(b"".join(small), "cpu").numpy()
    assert default_metrics.counters.get("mjpeg.rstless_host_frames", 0) == \
        before
    assert default_metrics.counters.get("speculative.batches", 0) == batches
    params = EncodeParams(h=2, v=2, quality=95, restart_interval=0,
                          optimize=False, exact=False)
    big = [encode_jpeg(make_ppm(192, 128, seed=s), params) for s in (1, 2)]
    assert min(map(len, big)) > jt.mjpeg.RSTLESS_DEVICE_MAX_BYTES
    got = jt.mjpeg.decode_stream_device(b"".join(big), "cpu").numpy()
    assert default_metrics.counters.get("mjpeg.rstless_host_frames", 0) == \
        before
    assert default_metrics.counters["speculative.batches"] == batches + 1
    for frames, out in ((small, px), (big, got)):
        for i, f in enumerate(frames):
            want = jpeg_tpu.decode_jpeg(f, exact=False).pixels()
            assert np.abs(out[i].astype(int) - want).max() <= 1
