"""PyTorch port: Motion-JPEG device encode vs jpeg_tpu (CPU).

The plain versions of the port's three encode kernels against the JAX
package's device programs on the same seeded inputs:

* ``pixels_to_zz_ref`` vs ``device_encode._pixels_to_zz`` (jitted on the
  CPU): within +-1 per quantized coefficient, because the float32 FDCT
  sums in another order (the JAX package's own device-vs-host contract),
  and equal on a frame of exact rounding ties (half away from zero);
* ``encode_scan_ref`` vs ``encode_scan_device3``: every segment's bits,
  ``seg_bits`` and ``missing`` equal;
* ``hist_from_blocks_ref`` vs ``hist_from_blocks``: exactly equal;

and the port's ``DeviceEncoder`` on the CPU against jpeg_tpu's: bytes
identical wherever the quantized blocks agree, and every output decodes
on jpeg_tpu's serial oracle to exactly the port's blocks, with every
chunk through the native host tail (``native.finalize_flat_native``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import jpeg_tpu
from jpeg_tpu.encoder import EncodeParams as JEncodeParams
from jpeg_tpu.entropy.encode_jax import encode_scan_device3, hist_from_blocks
from jpeg_tpu.models.device_encode import DeviceEncoder as JDeviceEncoder
from jpeg_tpu.models.device_encode import _pixels_to_zz
from jpeg_tpu.ops import color as jcolor
from jpeg_tpu.ops import dct as jdct
from jpeg_tpu.ops import quant as jquant
from jpeg_tpu.ops import resample as jresample

import jpeg_tpu_torch as jt
from jpeg_tpu_torch.constants import STD_LUMINANCE_QUANT, ZIGZAG, scale_qtable
from jpeg_tpu_torch.device import set_precision
from jpeg_tpu_torch.encoder import EncodeParams
from jpeg_tpu_torch.entropy import encode_cuda
from jpeg_tpu_torch.entropy.encode_torch import (
    block_symbols,
    encode_scan_ref,
    hist_from_blocks_ref,
)
from jpeg_tpu_torch.models import encode_dense
from jpeg_tpu_torch.models.encode_dense import pixels_to_zz, raster_to_zz
from jpeg_tpu_torch.ops import color, dct, quant, resample
from jpeg_tpu_torch.utils import synth
from jpeg_tpu_torch.utils.metrics import default_metrics
from jpeg_tpu_torch.utils.pnm import read_pnm
from refbin import make_pgm, make_ppm

_jit_pixels_to_zz = jax.jit(_pixels_to_zz, static_argnames=("geom",))
_jit_hist = jax.jit(hist_from_blocks, static_argnums=(3,))

# name -> (components, h, v, height, width, precision, restart interval)
DENSE_CASES = {
    "420_odd_size": (3, 2, 2, 38, 54, 8, 2),  # MCU padding on both edges
    "422": (3, 2, 1, 32, 48, 8, 3),
    "444": (3, 1, 1, 24, 40, 8, 5),
    "gray": (1, 1, 1, 37, 45, 8, 4),
    "p12_422": (3, 2, 1, 32, 48, 12, 2),
}


def _frames(comps, height, width, precision, n, seed=0):
    maxval = (1 << precision) - 1
    make = make_ppm if comps == 3 else make_pgm
    px = np.stack([read_pnm(make(width, height, seed=seed + i,
                                 maxval=maxval)).data for i in range(n)])
    return px.astype(np.uint8 if precision <= 8 else np.uint16)


def _encoders(comps, h, v, height, width, precision, ri, quality=80):
    kw = dict(h=h, v=v, quality=quality, optimize=False, restart_interval=ri,
              exact=False)
    port = jt.DeviceEncoder.for_config(height, width, comps,
                                       EncodeParams(**kw), precision=precision,
                                       device="cpu")
    ref = JDeviceEncoder.for_config(height, width, comps, JEncodeParams(**kw),
                                    precision=precision)
    return port, ref


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_pixels_to_zz_matches_jax(case):
    set_precision()
    comps, h, v, height, width, precision, ri = DENSE_CASES[case]
    port, ref = _encoders(comps, h, v, height, width, precision, ri)
    for name in ("visit_src", "prev_idx", "dc_tab", "ac_tab", "seg_of",
                 "qtables", "ehufco", "ehufsi"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name),
                                      err_msg=name)
    assert port.header == ref.header
    px = _frames(comps, height, width, precision, 2, seed=7)
    want = np.asarray(_jit_pixels_to_zz(
        jnp.asarray(px), jnp.asarray(ref.qtables), jnp.asarray(ref.prev_idx),
        geom=ref.geom))
    got = pixels_to_zz(torch.from_numpy(px), torch.from_numpy(port.qtables),
                       torch.from_numpy(port.prev_idx), port.geom)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    diff = np.abs(got.numpy().astype(np.int64) - want)
    assert diff.max() <= 1  # float32 FDCT sums in another order
    assert (diff == 0).mean() > 0.999
    assert encode_dense.pixels_to_zz.launches == 0  # CPU: plain version


def test_pixels_to_zz_rounds_ties_away():
    # One off-level sample per block makes each coefficient one float32
    # product in any sum order, so the ties are exact and both sides equal.
    set_precision()
    qtable = scale_qtable(STD_LUMINANCE_QUANT, 50)
    frame, want = synth.tie_frame(dct._kron_mats()[1], qtable)
    port, ref = _encoders(1, 1, 1, 8, frame.shape[1], 8, 1, quality=50)
    np.testing.assert_array_equal(port.qtables[0], qtable)
    assert (port.prev_idx == -1).all()  # one block per interval: raw DC
    got = pixels_to_zz(torch.from_numpy(frame[None]),
                       torch.from_numpy(port.qtables),
                       torch.from_numpy(port.prev_idx), port.geom).numpy()
    jgot = np.asarray(_jit_pixels_to_zz(
        jnp.asarray(frame[None]), jnp.asarray(ref.qtables),
        jnp.asarray(ref.prev_idx), geom=ref.geom))
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(got, want[:, ZIGZAG])


def test_encode_ops_match_jax():
    rng = np.random.default_rng(3)
    px = rng.integers(0, 256, (2, 16, 24, 3)).astype(np.float32)
    # same float32 ops in the same order: equal bit for bit
    np.testing.assert_array_equal(
        color.rgb_to_ycc(torch.from_numpy(px), 8).numpy(),
        np.asarray(jcolor.rgb_to_ycc(jnp.asarray(px), 8, exact=False)))
    plane = (rng.standard_normal((2, 16, 24)) * 80).astype(np.float32)
    np.testing.assert_array_equal(
        resample.downsample_box(torch.from_numpy(plane), 2, 2).numpy(),
        np.asarray(jresample.downsample_box(jnp.asarray(plane), 2, 2)))
    flat = (rng.standard_normal((50, 64)) * 100).astype(np.float32)
    # outputs reach ~1e3; float32 sums in another order differ by ~1e-4
    np.testing.assert_allclose(
        dct.fdct8x8_kron(torch.from_numpy(flat)).numpy(),
        np.asarray(jdct.fdct8x8_kron(jnp.asarray(flat))), rtol=0, atol=1e-3)
    q = rng.integers(1, 100, 64).astype(np.int32)
    c = (rng.standard_normal((50, 64)) * 300).astype(np.float32)
    c[0, :4] = [q[0] * 2.5, -q[1] * 2.5, q[2] * 0.5, -q[3] * 0.5]  # ties
    np.testing.assert_array_equal(
        quant.quantize(torch.from_numpy(c), torch.from_numpy(q)).numpy(),
        np.asarray(jquant.quantize(jnp.asarray(c), jnp.asarray(q))))


# ---- entropy stage ------------------------------------------------------

SCAN_GEOM = (3, 2, 2, 48, 64, 12, 2)  # 2 frames: 144 blocks, 12 segments


def _tables_for(enc, zz, drop=None):
    """Per-batch optimized code tables for ``zz`` (every symbol coded), or
    with the symbol ``drop`` = (table row, value) left without a code."""
    hist = enc.histogram(torch.from_numpy(zz)).numpy()
    if drop is not None:
        hist[drop] = 0
    ehufco, ehufsi, _ = enc.optimized_tables(hist)
    return ehufco.numpy(), ehufsi.numpy()


def _scan_inputs(kind):
    """(encoder, zz [B, 64], ehufco, ehufsi) for one scan test input."""
    comps, h, v, height, width, precision, ri = SCAN_GEOM
    enc, _ = _encoders(comps, h, v, height, width, precision, ri)
    if kind == "frames":
        px = _frames(comps, height, width, precision, 2, seed=21)
        zz = enc.dense(torch.from_numpy(px)).numpy()
        return enc, zz, *_tables_for(enc, zz)
    zz = synth.symbol_blocks(2 * enc.blocks_per_frame)
    if kind == "symbols":
        return enc, zz, *_tables_for(enc, zz)
    # DC category 15 (only in block 5, luma) gets no code: missing.
    return enc, zz, *_tables_for(enc, zz, drop=(0, 15))


@pytest.mark.parametrize("kind", ["frames", "symbols", "missing"])
def test_encode_scan_ref_matches_jax(kind):
    enc, zz, ehufco, ehufsi = _scan_inputs(kind)
    frames = zz.shape[0] // enc.blocks_per_frame
    order, seg_of, dc_tab, ac_tab = (t.numpy() for t in enc.chunk_tables(frames))
    n_seg = frames * enc.n_segments
    words, wbase, seg_bits, missing = encode_scan_ref(
        *(torch.from_numpy(a) for a in (zz, order, seg_of, dc_tab, ac_tab,
                                        ehufco, ehufsi)), n_seg)
    # Capacities that cover any block (68 item slots, 63 nonzeros, 70
    # words per block, the worst-case segment), so JAX never overflows.
    wps = (int(np.bincount(seg_of).max()) * 68 * 31) // 32 + 2
    jw, jbits, jover, jmiss = encode_scan_device3(
        jnp.asarray(zz), jnp.asarray(dc_tab), jnp.asarray(ac_tab),
        jnp.asarray(ehufco), jnp.asarray(ehufsi), jnp.asarray(seg_of), n_seg,
        wps, 68, order=jnp.asarray(order), nz_cap=63, wpb_cap=70)
    assert int(jover) == 0
    jw, jbits = np.asarray(jw), np.asarray(jbits)
    np.testing.assert_array_equal(seg_bits.numpy(), jbits)
    assert bool(missing) == bool(jmiss) == (kind == "missing")
    w = words.numpy().view(np.uint32)
    nw = (jbits + 31) // 32
    np.testing.assert_array_equal(wbase.numpy(), np.cumsum(nw) - nw)
    assert w.size == nw.sum()
    for s in range(n_seg):
        np.testing.assert_array_equal(
            w[wbase[s]:wbase[s] + nw[s]], jw[s, :nw[s]], err_msg=f"seg {s}")
    if kind == "symbols":
        sym = block_symbols(torch.from_numpy(zz))
        assert int(sym["zrl"][4]) == 3 and int(sym["eob"][4]) == 0
        assert int(sym["eob"][3]) == 0 and int(sym["dcat"][5]) == 15
        assert int(sym["cat"][5].max()) == 14


@pytest.mark.parametrize("kind", ["frames", "symbols", *synth.HIST_CASES])
def test_hist_from_blocks_ref_matches_jax(kind):
    """The plain histogram equals jpeg_tpu's on encoder blocks, on a chunk
    of every symbol kind, and on the hostile cases of
    ``synth.hostile_hist`` (INT_MIN and +-32767, no EOB, zero runs of 16,
    31 and 47, eight tables)."""
    if kind in synth.HIST_CASES:
        zz, dc_tab, ac_tab, T = synth.hostile_hist(kind)
    else:
        enc, zz, _, _ = _scan_inputs(kind)
        frames = zz.shape[0] // enc.blocks_per_frame
        dc_tab = np.tile(enc.dc_tab, frames)
        ac_tab = np.tile(enc.ac_tab, frames)
        T = len(enc.table_keys)
    got = hist_from_blocks_ref(torch.from_numpy(zz), torch.from_numpy(dc_tab),
                               torch.from_numpy(ac_tab), T)
    want = np.asarray(_jit_hist(jnp.asarray(zz), jnp.asarray(dc_tab),
                                jnp.asarray(ac_tab), T))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert encode_cuda.block_histogram(
        torch.from_numpy(zz), torch.from_numpy(dc_tab),
        torch.from_numpy(ac_tab), T).equal(got)
    assert encode_cuda.block_histogram.launches == 0


def test_block_histogram_adds_into_out():
    """``out=`` adds the counts into the caller's histogram and returns
    it: what ``encode_batch(optimize=True)`` keeps as its one accumulator
    a batch."""
    zz, dc_tab, ac_tab, T = synth.hostile_hist("tables8")
    args = (torch.from_numpy(zz), torch.from_numpy(dc_tab),
            torch.from_numpy(ac_tab), T)
    acc = torch.from_numpy(np.random.default_rng(3).integers(
        0, 1000, (T, 256)).astype(np.int32))
    want = acc + hist_from_blocks_ref(*args)
    got = encode_cuda.block_histogram(*args, out=acc)
    assert got is acc and got.dtype == torch.int32
    assert got.equal(want)
    assert encode_cuda.block_histogram.launches == 0


@pytest.mark.parametrize("bad", ["int64", "shape", "strided"])
def test_block_histogram_rejects_bad_out(bad):
    """The plain path checks ``out=`` as the kernel's does: an int32
    [T, 256] contiguous tensor on ``zz``'s device, else ``ValueError``,
    and ``out`` is left as it was."""
    zz, dc_tab, ac_tab, T = synth.hostile_hist("tables8")
    out = {"int64": torch.zeros(T, 256, dtype=torch.int64),
           "shape": torch.zeros(1, 256, dtype=torch.int32),
           "strided": torch.zeros(256, T, dtype=torch.int32).t()}[bad]
    with pytest.raises(ValueError):
        encode_cuda.block_histogram(torch.from_numpy(zz),
                                    torch.from_numpy(dc_tab),
                                    torch.from_numpy(ac_tab), T, out=out)
    assert not out.any()


# ---- the whole encoder --------------------------------------------------

def _blocks_of(jpeg, prev_idx):
    """jpeg_tpu's serial-oracle coefficients of one frame as natural-order
    zig-zag rows with differential DC (the encoder's block contract)."""
    cs, planes = jpeg_tpu.decode_coefficients(jpeg, entropy="serial")
    comps = sorted(cs.geometry.components, key=lambda c: c.cid)
    raster = np.concatenate([np.asarray(planes[c.cid], np.int32)
                             .reshape(-1, 64) for c in comps])
    return raster_to_zz(torch.from_numpy(raster)[None],
                        torch.from_numpy(prev_idx)).numpy()


def _assert_matches_jax(case, optimize, chunk=8):
    """The port's ``encode_batch`` against jpeg_tpu's on 3 frames: each
    frame decodes to exactly the port's blocks, is within 1 of
    jpeg_tpu's, and byte-identical wherever the blocks agree; every
    chunk takes the native host tail.  Restart interval 0: both encoders
    (which need one) at one segment a frame, with the header's DRI
    dropped."""
    comps, h, v, height, width, precision, ri = case
    set_precision()
    port, ref = _encoders(comps, h, v, height, width, precision,
                          ri or 0xFFFF)
    if not ri:
        assert port.n_segments == 1 and port.header == ref.header
        dri = port.header.index(b"\xff\xdd\x00\x04")
        header = port.header[:dri] + port.header[dri + 6:]
        port = dataclasses.replace(port, header=header)
        ref = dataclasses.replace(ref, header=header)
    px = _frames(comps, height, width, precision, 3)
    c = default_metrics.counters
    before = (c["device_encode.native_finalize_chunks"],
              c["device_encode.python_finalize_chunks"])
    got = port.encode_batch(torch.from_numpy(px), optimize=optimize,
                            chunk=chunk)
    assert (c["device_encode.native_finalize_chunks"] - before[0],
            c["device_encode.python_finalize_chunks"] - before[1]) \
        == (-(-3 // chunk), 0)
    want = ref.encode_batch(px, optimize=optimize)
    blocks = port.dense(torch.from_numpy(px)).numpy().reshape(3, -1, 64)
    agree = []
    for i in range(3):
        mine = _blocks_of(got[i], port.prev_idx)
        np.testing.assert_array_equal(mine, blocks[i])  # decodes exactly
        theirs = _blocks_of(want[i], port.prev_idx)
        assert np.abs(theirs - mine).max() <= 1
        agree.append(np.array_equal(theirs, mine))
    # Per-batch optimized tables depend on every frame's blocks.
    same = agree if not optimize else [all(agree)] * 3
    for i in range(3):
        if same[i]:
            assert got[i] == want[i]
    assert any(same)


@pytest.mark.parametrize("optimize", [False, True])
def test_device_encoder_matches_jax(optimize):
    _assert_matches_jax((3, 2, 2, 72, 96, 8, 3), optimize)


# name -> ((components, h, v, height, width, precision, restart
# interval), optimize): the native host tail under each restart layout,
# sampling and precision, with default and per-batch tables.
TAIL_CASES = {
    "420_one_segment": ((3, 2, 2, 32, 48, 8, 6), False),  # 6 MCUs: no RSTn
    "420_ri0": ((3, 2, 2, 40, 56, 8, 0), False),  # no DRI
    "420_ri2_optimized": ((3, 2, 2, 38, 54, 8, 2), True),
    "444_ri4": ((3, 1, 1, 24, 40, 8, 4), False),
    "gray_ri4_optimized": ((1, 1, 1, 37, 45, 8, 4), True),
    "p12_420_ri2": ((3, 2, 2, 32, 48, 12, 2), False),
    "p12_420_ri2_optimized": ((3, 2, 2, 32, 48, 12, 2), True),
}


@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_device_encoder_native_tail_matches_jax(case):
    geometry, optimize = TAIL_CASES[case]
    _assert_matches_jax(geometry, optimize, chunk=2)


@pytest.mark.parametrize("optimize", [False, True])
def test_encoder_round_trip_and_chunks(optimize):
    # 12-bit 4:2:2 with segments that tile MCU rows, so the port's
    # DeviceDecoder takes the output.
    comps, h, v, height, width, precision, ri = (3, 2, 1, 32, 48, 12, 3)
    enc, _ = _encoders(comps, h, v, height, width, precision, ri)
    px = torch.from_numpy(_frames(comps, height, width, precision, 5))
    whole = enc.encode_batch(px, optimize=optimize, chunk=8)
    assert enc.encode_batch(px, optimize=optimize, chunk=2) == whole
    dec = jt.DeviceDecoder.for_stream(whole[0], "cpu")
    coeffs = dec.decode_coeffs_batch(whole).reshape(5, -1, 64)
    np.testing.assert_array_equal(
        raster_to_zz(coeffs, torch.from_numpy(enc.prev_idx)).numpy(),
        enc.dense(px).numpy())
    assert len(set(len(w) for w in whole)) > 1  # frames differ


def test_encoder_rejections():
    with pytest.raises(jt.UnsupportedError, match="shared tables"):
        jt.DeviceEncoder.for_config(
            16, 16, 3, EncodeParams(restart_interval=1, optimize=True),
            device="cpu")
    with pytest.raises(jt.UnsupportedError, match="restart interval"):
        jt.DeviceEncoder.for_config(
            16, 16, 3, EncodeParams(restart_interval=0, optimize=False),
            device="cpu")
    enc = jt.DeviceEncoder.for_config(
        16, 32, 3, EncodeParams(h=2, v=2, restart_interval=1,
                                optimize=False), device="cpu")
    with pytest.raises(jt.UnsupportedError, match="built for"):
        enc.encode_batch(torch.zeros(1, 16, 16, 3, dtype=torch.uint8))
    with pytest.raises(jt.UnsupportedError, match="must be"):
        enc.encode_batch(torch.zeros(1, 16, 32, 3, dtype=torch.uint16))
    if not torch.cuda.is_available():  # no card: "cuda" raises, no fallback
        with pytest.raises(RuntimeError, match="cuda"):
            jt.DeviceEncoder.for_config(
                16, 32, 3, EncodeParams(h=2, v=2, restart_interval=1,
                                        optimize=False), device="cuda")
    # A symbol without a code in the selected tables raises, as in JAX.
    enc.ehufsi = enc.ehufsi.copy()
    enc.ehufsi[0, 0] = 0  # luma DC category 0 (a flat frame) has no code
    with pytest.raises(jt.UnsupportedError, match="no code"):
        enc.encode_batch(torch.full((1, 16, 32, 3), 128, dtype=torch.uint8))


def test_wrappers_refuse_other_devices():
    enc, _ = _encoders(3, 2, 2, 16, 16, 8, 1)
    px = torch.zeros(1, 16, 16, 3, dtype=torch.uint8)
    zz = enc.dense(px)
    order, seg_of, dc_tab, ac_tab = enc.chunk_tables(1)
    co, si = torch.from_numpy(enc.ehufco), torch.from_numpy(enc.ehufsi)
    meta = [t.to("meta") for t in (zz, order, seg_of, dc_tab, ac_tab, co, si)]
    with pytest.raises(ValueError, match="device"):
        pixels_to_zz(px.to("meta"), torch.from_numpy(enc.qtables),
                     torch.from_numpy(enc.prev_idx), enc.geom)
    with pytest.raises(ValueError, match="device"):
        encode_cuda.encode_scan(*meta, enc.n_segments)
    with pytest.raises(ValueError, match="device"):
        encode_cuda.block_histogram(meta[0], meta[3], meta[4], 4)
    assert encode_cuda.encode_scan.launches == 0


def test_make_frame_matches_bench():
    for seed in range(2):
        data = synth.make_frame_ppm(seed)
        assert data == bench.make_frame_ppm(seed)
        np.testing.assert_array_equal(
            synth.make_frame(seed), read_pnm(data).data.astype(np.uint8))
