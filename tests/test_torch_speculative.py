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
against the JAX engine.

The JAX package's own device path (``models.device_decode.
decode_stream_rstless``) is not run here: its first call on one 192x128
4:2:0 frame takes about 110 s on the CPU, nearly all of it compiling,
past this file's ~60 s budget.  Its semantics are the serial oracle's,
which every test here holds the port to.
"""

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
           strip_bytes=speculative.STRIP_BYTES, segments=None):
    plan, tb = plan_of(frames[0])
    segs = segments or [segment_of(f) for f in frames]
    return speculative.speculative_core_batch(plan, tb, segs, CPU,
                                              chunk_bytes, strip_bytes)


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
    """K8's links on an intact frame, K9's rows and K10's row checks."""
    data = rstless("420")
    plan, tb = plan_of(data)
    words, nbits, rows = speculative.prepare_batch([segment_of(data)], CPU,
                                                   64)
    links, member = speculative_cuda.sync(plan, words, nbits, rows, 512, 128)
    bpm = plan.blocks_per_mcu
    assert links.shape == (rows.R * bpm, st.NCOL)
    assert member.shape == (rows.R * 128 * bpm,)
    # the frame's last row ends at the segment's end, every other row links
    # or misses; variant 0 of row 0 starts at the true origin
    assert int(links[(rows.R - 1) * bpm, st.L_ST]) == st.ST_END
    assert set(links[:(rows.R - 1) * bpm, st.L_ST].tolist()) <= {
        st.ST_LINK, st.ST_MISS, st.ST_END}
    res, stats = speculative_cuda.resolve(plan, words, nbits, rows, links,
                                          member, 512, 128, rows.R + 1)
    f_bit, f_slot, nblk, state, bad = res
    assert int(f_bit[0]) == 0 and int(f_slot[0]) == 0
    assert (state == st.SETTLED).all() and int(bad.sum()) == 0
    assert int(nblk.sum()) >= plan.n_mcus * bpm
    coeffs, ok = speculative_cuda.final(plan, words, nbits, rows, f_bit,
                                        f_slot, nblk, tb)
    assert bool((ok == 1).all())
    np.testing.assert_array_equal(coeffs.numpy(), oracle(data)[0])
    # the wrappers launch or raise on a device that is neither
    with pytest.raises(ValueError, match="device"):
        speculative_cuda.sync(plan, words.to("meta"), nbits.to("meta"),
                              rows, 512, 128)


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
    links, _ = speculative_cuda.sync(plan, words, nbits, rows, chunk * 8, 8)
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
                                         (64.0, 16), (True, 1)])
def test_capacity_out_of_range_raises(chunk, strip):
    """ADVICE: the JAX engine reads TCAP/HCAP from the environment without
    validation.  The port has no such knob: its sizes are constants, and
    a size out of range raises."""
    with pytest.raises(ValueError):
        speculative.check_capacity(chunk, strip)
    with pytest.raises(ValueError):
        engine([rstless("gray")], chunk, strip)
    speculative.check_capacity(speculative.CHUNK_BYTES,
                               speculative.STRIP_BYTES)
