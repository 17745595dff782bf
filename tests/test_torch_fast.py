"""PyTorch port: the fast mode's dense stages (K11, K12) vs jpeg_tpu (CPU).

``models/dense_fast.decode_frame_fast_ref`` is held against jpeg_tpu's
jitted ``api._jitted_decode_frame(geom, False)`` within ``|got - ref| <=
1e-3 + 1e-5 * max|ref|`` (both sum their float32 DCTs in their own order)
on the single-image corpus (4:2:0, 4:2:2, 4:4:4, gray, 12-bit, a sampling
ratio that does not divide, YCCK and a frame whose SOF lists the
component ids 3, 1, 2), intact and with seeded +-40 coefficient noise;
``encode_frame_fast_ref`` against ``encoder._jitted_encode_frame(geom,
False)`` integer for integer.  The kernels cannot run here, so their
index arithmetic is held by Python models of csrc/dense_fast.cu (the
tiles, the spans of source blocks, the stage order and the gathers)
against the plain versions, and the spans against a brute-force read of
every pixel's sample.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jpeg_tpu
from jpeg_tpu.api import _jitted_decode_frame
from jpeg_tpu.encoder import EncodeParams as JParams
from jpeg_tpu.encoder import _jitted_encode_frame
from jpeg_tpu.encoder import geometry_for_image as jax_geometry_for_image
from jpeg_tpu.geometry import Component as JComponent
from jpeg_tpu.utils.pnm import read_pnm as jax_read_pnm

import jpeg_tpu_torch as jt
from jpeg_tpu_torch.encoder import EncodeParams, geometry_for_image
from jpeg_tpu_torch.geometry import Component, FrameGeometry, with_block_grid
from jpeg_tpu_torch.models import dense_fast
from jpeg_tpu_torch.models.dense_fast import (
    block_stores,
    comp_records,
    decode_frame_fast,
    decode_frame_fast_ref,
    decode_tiles,
    encode_frame_fast,
    encode_frame_fast_ref,
    encode_tiles,
    tile_runs,
    tile_sources,
)
from jpeg_tpu_torch.models.pipeline import decode_frame, encode_frame
from jpeg_tpu_torch.ops.color import rgb_to_ycc, to_rgb
from jpeg_tpu_torch.ops.dct import fdct8x8_matmul, idct8x8_matmul
from jpeg_tpu_torch.ops.quant import dequantize, quantize
from jpeg_tpu_torch.utils import synth
from jpeg_tpu_torch.utils.pnm import read_pnm
from test_torch_api import SHAPES, _crafted, _pnm


def _tol(ref: np.ndarray) -> float:
    return 1e-3 + 1e-5 * float(np.abs(ref).max())


def _jax_crafted(name):
    comps, seed = synth.CRAFTED[name]
    return _crafted(tuple(JComponent(cid=c, h=h, v=v, tq=t, td=t, ta=t)
                          for c, h, v, t in comps),
                    tuple(c[3] for c in comps), seed)


@pytest.fixture(scope="module")
def frames():
    """name -> JPEG bytes: the single-image corpus of test_torch_api, and
    a frame whose SOF lists ids 3, 1, 2 (the full-size component first,
    last in id order, so channel and plane orders differ)."""
    out = {name: jax_encode_exact(name) for name in SHAPES}
    out.update({name: _jax_crafted(name) for name in synth.CRAFTED})
    return out


@pytest.mark.parametrize("name", list(synth.CRAFTED))
def test_crafted_frames_match_the_jax_emitter(name):
    """The chip check builds its crafted frames with the port's emitter:
    the same bytes as the JAX package's."""
    assert synth.crafted(name) == _jax_crafted(name)


def jax_encode_exact(name):
    h, v = SHAPES[name][:2]
    return jpeg_tpu.encode_jpeg(_pnm(name), JParams(
        h=h, v=v, quality=85, optimize=True, restart_interval=2, exact=True))


NAMES = list(SHAPES) + ["nondividing", "ycck", "cid312"]


def _plane_major(planes, geom) -> np.ndarray:
    return np.concatenate([planes[c.cid] for c in geom.components])


@pytest.mark.parametrize("noise", [False, True], ids=["intact", "noise"])
@pytest.mark.parametrize("name", NAMES)
def test_decode_ref_matches_jax(frames, name, noise):
    data = frames[name]
    cs, planes = jt.decode_coefficients(data)
    jcs, jplanes = jpeg_tpu.decode_coefficients(data)
    if noise:
        rng = np.random.default_rng(NAMES.index(name))
        for cid in planes:
            planes[cid] = planes[cid] + rng.integers(
                -40, 41, planes[cid].shape).astype(np.int32)
            jplanes[cid] = planes[cid].copy()
    qt = cs.qtables.astype(np.int32)
    want = np.asarray(_jitted_decode_frame(jcs.geometry, False)(jplanes, qt))
    geom = cs.geometry
    got = decode_frame_fast_ref(torch.from_numpy(_plane_major(planes, geom)),
                                torch.from_numpy(qt), geom).numpy()
    assert got.shape == want.shape == (geom.size_y, geom.size_x, geom.nf)
    assert np.abs(got - want).max() <= _tol(want)
    # The pipeline's fast mode is the plain version on the CPU.
    via = decode_frame(planes, geom, qt, exact=False, device="cpu").numpy()
    np.testing.assert_array_equal(via, got)
    if not noise:
        np.testing.assert_array_equal(
            jt.decode_jpeg(data, "cpu", exact=False).frame, got)


def _encode_inputs(name):
    h, v = SHAPES[name][:2]
    pnm = _pnm(name)
    geom = geometry_for_image(read_pnm(pnm), EncodeParams(h=h, v=v))
    img = read_pnm(pnm, pad_to=(8 * geom.max_v, 8 * geom.max_h))
    qt = np.ones((4, 64), np.int32)
    rng = np.random.default_rng(len(name))
    qt[:2] = rng.integers(1, 100, (2, 64))
    return pnm, geom, img.data, qt


@pytest.mark.parametrize("name", list(SHAPES))
def test_encode_ref_matches_jax(name):
    pnm, geom, data, qt = _encode_inputs(name)
    h, v = SHAPES[name][:2]
    jgeom = jax_geometry_for_image(jax_read_pnm(pnm), JParams(h=h, v=v))
    want = _jitted_encode_frame(jgeom, False)(data, qt)
    got = encode_frame_fast_ref(torch.from_numpy(data), torch.from_numpy(qt),
                                geom)
    via = encode_frame(torch.from_numpy(data), geom, qt, exact=False)
    off = 0
    for c in geom.components:
        np.testing.assert_array_equal(got[off:off + c.n_blocks].numpy(),
                                      np.asarray(want[c.cid]))
        np.testing.assert_array_equal(via[c.cid].numpy(),
                                      np.asarray(want[c.cid]))
        off += c.n_blocks
    assert off == got.shape[0]


def _geom(comps, height, width, precision=8):
    return with_block_grid(FrameGeometry(
        precision=precision, height=height, width=width,
        components=tuple(Component(cid=c, h=h, v=v, tq=tq)
                         for c, h, v, tq in comps)))


YCC = ((1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1))
# name -> (components (id, h, v, tq), height, width): every sampling the
# corpus has, and the ones it lacks (h=1 v=2 luma, 4:1:1, ratios that do
# not divide either way), at sizes that leave a row's last tile short.
GEOMS = {
    "420 1080p": (((1, 2, 2, 0),) + YCC[1:], 1080, 1920),
    "420": (((1, 2, 2, 0),) + YCC[1:], 29, 37),
    "422": (((1, 2, 1, 0),) + YCC[1:], 21, 300),
    "444": (YCC, 17, 24),
    "gray": (((1, 1, 1, 0),), 20, 30),
    "ycck": (YCC + ((4, 1, 1, 0),), 24, 40),
    "h1v2": (((1, 1, 2, 0),) + YCC[1:], 38, 54),
    "411": (((1, 4, 1, 0),) + YCC[1:], 40, 300),
    "nondividing": (((1, 3, 1, 0), (2, 2, 1, 1), (3, 1, 1, 1)), 24, 40),
    "nondividing wide": (((1, 3, 1, 0), (2, 2, 1, 1), (3, 1, 1, 1)), 70,
                         500),
    "nondividing tall": (((1, 1, 3, 0), (2, 1, 2, 1), (3, 1, 1, 1)), 130,
                         60),
    "cid312": (((3, 2, 2, 0), (1, 1, 1, 1), (2, 1, 2, 1)), 24, 40),
    # the largest sampling a SOF holds: an MCU's blocks overflow a CTA,
    # so the tiles shrink below one MCU
    "15x15 x4": (tuple((i, 15, 15, i % 2) for i in (1, 2, 3, 4)), 130,
                 130),
}


def test_comp_records():
    g = _geom(*GEOMS["420"])
    np.testing.assert_array_equal(comp_records(g, "decode"), [
        (2, 2, 1, 1, 0, 6, 0, 0), (1, 1, 2, 2, 24, 3, 1, 1),
        (1, 1, 2, 2, 30, 3, 1, 2), (0,) * 8])
    g = _geom(*GEOMS["cid312"])  # 40 x 24: 3 x 2 MCUs of 16 x 16
    dec = comp_records(g, "decode")
    # output channels by ascending id; encode channels by geometry index
    np.testing.assert_array_equal(dec[:3, 7], [2, 0, 1])
    np.testing.assert_array_equal(comp_records(g, "encode")[:3, 7],
                                  [0, 1, 2])
    np.testing.assert_array_equal(dec[:3, :7], [
        (2, 2, 1, 1, 0, 6, 0), (1, 1, 2, 2, 24, 3, 1),
        (1, 2, 1, 2, 30, 3, 1)])
    g = _geom(*GEOMS["nondividing"])  # 48 x 24 padded, MCU 24 x 8
    np.testing.assert_array_equal(comp_records(g, "decode")[:3, :6], [
        (3, 1, 1, 1, 0, 6), (2, 1, 1, 1, 18, 4), (1, 1, 1, 3, 30, 2)])


def _reads(p0, p1, step, painted):
    """The block indices the pixels [p0, p1) of one axis read."""
    return sorted({(p // step) // 8 for p in range(p0, min(p1, painted))})


@pytest.mark.parametrize("name", list(GEOMS))
def test_tile_sources_cover_every_sample(name):
    """Every pixel of the padded frame lies in one tile, and the tile's
    span of each component is exactly the blocks its pixels read (none
    missing, none extra); the stage holds the largest tile's blocks."""
    g = _geom(*GEOMS[name])
    tiles = decode_tiles(g)
    rec = comp_records(g, "decode")
    assert dense_fast.decode_smem(tiles) <= dense_fast.SMEM_MAX
    if name == "15x15 x4":  # 4 x 225 blocks an MCU: narrower tiles
        assert (tiles.tile_h, tiles.tile_w) == (120, 24)
    else:  # an MCU row of whole MCUs
        assert tiles.tile_h == 8 * g.max_v
        assert tiles.tile_w % (8 * g.max_h) == 0
    assert (tiles.tiles_y - 1) * tiles.tile_h < g.size_y <= \
        tiles.tiles_y * tiles.tile_h
    assert (tiles.tiles_x - 1) * tiles.tile_w < g.size_x <= \
        tiles.tiles_x * tiles.tile_w
    # The read sets are separable (a pixel reads block (f(y), g(x)) where
    # y and x are below the painted size), so each axis is checked alone
    # over every tile row and column, and the whole rectangle on a few.
    most = 0
    for ty in range(tiles.tiles_y):
        for tx in range(tiles.tiles_x):
            src = tile_sources(g, tiles, ty, tx)
            most = max(most, sum(s[1] * s[3] for s in src))
            if ty and tx and ty != tiles.tiles_y - 1 and \
                    tx != tiles.tiles_x - 1:
                continue
            y0, x0 = ty * tiles.tile_h, tx * tiles.tile_w
            y1 = min(y0 + tiles.tile_h, g.size_y)
            x1 = min(x0 + tiles.tile_w, g.size_x)
            for j, c in enumerate(g.components):
                sy, sx = int(rec[j, 2]), int(rec[j, 3])
                rows = _reads(y0, y1, sy, c.b_y * 8 * sy)
                cols = _reads(x0, x1, sx, c.b_x * 8 * sx)
                br0, nbr, bc0, nbc = src[j]
                if not rows or not cols:
                    assert nbr * nbc == 0
                    continue
                assert rows == list(range(br0, br0 + nbr))
                assert cols == list(range(bc0, bc0 + nbc))
                assert br0 + nbr <= c.b_y and bc0 + nbc <= c.b_x
    assert most == tiles.stage_blocks


def _small_geoms():
    return {k: v for k, v in GEOMS.items() if "1080p" not in k}


def _kernel_spans(rec, geom, box, pow2):
    """Channel k's span of a tile (br0, nbr, bc0, nbc) by the kernel's
    arithmetic: shifts on its common samplings, the division and the
    painted size otherwise (csrc/dense_fast.cu ``tile_spans``)."""
    y0, x0, y1, x1 = box
    out = []
    for k in range(geom.nf):
        _, v, sy, sx, _, b_x = (int(i) for i in rec[k, :6])
        if pow2:
            shy, shx = sy >> 1, sx >> 1
            br0, bc0 = (y0 >> shy) >> 3, (x0 >> shx) >> 3
            out.append((br0, (((y1 - 1) >> shy) >> 3) - br0 + 1,
                        bc0, (((x1 - 1) >> shx) >> 3) - bc0 + 1))
        else:
            out.append(dense_fast._span(y0, y1, sy, geom.m_y * v * 8 * sy)
                       + dense_fast._span(x0, x1, sx, b_x * 8 * sx))
    return out


def _pixel_runs(tiles, geom, ty, tx):
    """K11's runs of tile (ty, tx) in its loop order: e -> row e // rpr,
    4 pixels from column 4 * (e % rpr), rpr the tile's width / 4."""
    y0, x0 = ty * tiles.tile_h, tx * tiles.tile_w
    y1 = min(y0 + tiles.tile_h, geom.size_y)
    x1 = min(x0 + tiles.tile_w, geom.size_x)
    rpr = (x1 - x0) >> 2
    return [(y0 + e // rpr, x0 + 4 * (e % rpr))
            for e in range((y1 - y0) * rpr)]


def decode_kernel_model(coeffs, qtables, geom):
    """K11 tile by tile as csrc/dense_fast.cu computes it: the tile's copy
    runs (``tile_runs``) fill its coefficient stage, channel after
    channel; each stage block is dequantized with the table of the last
    channel whose stage starts at or before it and IDCT'd (the plain
    versions' IDCT); then each run of 4 pixels of a row takes each
    channel's 4 samples by the kernel's index arithmetic, the shift path
    (one aligned 4- or 2-sample read a run) where ``pow2_sampling`` holds
    and the general path (a division and the painted size a pixel)
    otherwise, and the plain colour ops.  Every output float is written
    exactly once."""
    tiles = decode_tiles(geom)
    rec = dense_fast.channel_records(geom)
    shift = float(1 << (geom.precision - 1))
    out = torch.full((geom.size_y, geom.size_x, geom.nf), float("nan"))
    writes = torch.zeros(geom.size_y, geom.size_x, dtype=torch.int32)
    for ty in range(tiles.tiles_y):
        for tx in range(tiles.tiles_x):
            y0, x0 = ty * tiles.tile_h, tx * tiles.tile_w
            box = (y0, x0, min(y0 + tiles.tile_h, geom.size_y),
                   min(x0 + tiles.tile_w, geom.size_x))
            spans = _kernel_spans(rec, geom, box, tiles.pow2)
            if tiles.pow2:  # the shift path's spans are the general ones
                assert spans == _kernel_spans(rec, geom, box, False)
            slots = np.concatenate([[0], np.cumsum(
                [s[1] * s[3] for s in spans])]).tolist()
            assert slots[-1] <= tiles.stage_blocks
            stage = torch.zeros(slots[-1], 64, dtype=torch.int32)
            filled = torch.zeros(slots[-1], dtype=torch.int32)
            for k, first, n, slot in tile_runs(geom, tiles, ty, tx):
                stage[slot:slot + n] = coeffs[first:first + n]
                filled[slot:slot + n] += 1
            assert (filled == 1).all()
            tq = [int(rec[max(k for k in range(geom.nf) if slots[k] <= g),
                          6]) for g in range(slots[-1])]
            flt = dequantize(stage, qtables[tq]).reshape(-1, 8, 8)
            flat = (idct8x8_matmul(flt) + shift).reshape(-1)
            for y, x in _pixel_runs(tiles, geom, ty, tx):
                ch = torch.zeros(4, geom.nf)
                for k in range(geom.nf):
                    _, v, sy, sx, _, b_x = (int(i) for i in rec[k, :6])
                    br0, _, bc0, nbc = spans[k]
                    if tiles.pow2:
                        ly = (y >> (sy >> 1)) - br0 * 8
                        lx = (x >> (sx >> 1)) - bc0 * 8
                        assert lx % (4 // sx) == 0  # the vector read
                        lxs = [lx + (i >> (sx >> 1)) for i in range(4)]
                        read = [True] * 4
                    else:
                        lxs = [(x + i) // sx - bc0 * 8 for i in range(4)]
                        ly = y // sy - br0 * 8
                        read = [y < geom.m_y * v * 8 * sy
                                and x + i < b_x * 8 * sx for i in range(4)]
                    for i in range(4):
                        if read[i]:
                            ch[i, k] = flat[(slots[k] + (ly >> 3) * nbc
                                             + (lxs[i] >> 3)) * 64
                                            + (ly & 7) * 8 + (lxs[i] & 7)]
                out[y, x:x + 4] = to_rgb(ch, geom.precision)
                writes[y, x:x + 4] += 1
    assert (writes == 1).all()
    return out


@pytest.mark.parametrize("name", list(_small_geoms()))
def test_decode_kernel_model(name):
    g = _geom(*GEOMS[name])
    rng = np.random.default_rng(len(name))
    tb = sum(c.n_blocks for c in g.components)
    coeffs = np.zeros((tb, 64), np.int32)
    coeffs[:, 0] = rng.integers(-60, 60, tb)
    coeffs[:, 1:10] = rng.integers(-12, 12, (tb, 9))
    qt = torch.from_numpy(rng.integers(1, 30, (4, 64)).astype(np.int32))
    c = torch.from_numpy(coeffs)
    want = decode_frame_fast_ref(c, qt, g)
    got = decode_kernel_model(c, qt, g)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, rtol=0, atol=_tol(want.numpy()))


@pytest.mark.parametrize("name", list(GEOMS))
def test_pixel_runs_cover_the_frame(name):
    """K11's runs of 4 pixels write every float of the output exactly
    once, each run inside one row of its tile and 16-byte aligned in a
    16-byte aligned frame."""
    g = _geom(*GEOMS[name])
    tiles = decode_tiles(g)
    assert tiles.tile_w % 8 == 0 and g.size_x % 8 == 0
    writes = np.zeros((g.size_y, g.size_x), np.int32)
    for ty in range(tiles.tiles_y):
        for tx in range(tiles.tiles_x):
            x1 = min((tx + 1) * tiles.tile_w, g.size_x)
            for y, x in _pixel_runs(tiles, g, ty, tx):
                assert x + 4 <= x1 and ((y * g.size_x + x) * g.nf * 4) % 16 == 0
                writes[y, x:x + 4] += 1
    assert (writes == 1).all()


@pytest.mark.parametrize("name", list(GEOMS))
def test_tile_runs_cover_tile_sources(name):
    """Each tile's copy runs cover its ``tile_sources`` rectangle of every
    component exactly once, a run a block row in 256-byte blocks, and
    fill the tile's stage blocks 0 .. n once each, channel after channel
    (channel k the component of the k-th smallest id)."""
    g = _geom(*GEOMS[name])
    tiles = decode_tiles(g)
    comp_of = {int(r): j for j, r in
               enumerate(comp_records(g, "decode")[:g.nf, 7])}
    first = np.cumsum([0] + [c.n_blocks for c in g.components])
    for ty in range(tiles.tiles_y):
        for tx in range(tiles.tiles_x):
            runs = tile_runs(g, tiles, ty, tx)
            src = tile_sources(g, tiles, ty, tx)
            slot = 0
            for k in range(g.nf):
                j = comp_of[k]
                c, (br0, nbr, bc0, nbc) = g.components[j], src[j]
                mine = [r for r in runs if r[0] == k]
                got = []
                for _, start, n, at in mine:
                    assert at == slot and n == nbc and n * 256 % 256 == 0
                    row, col = divmod(int(start - first[j]), c.b_x)
                    assert col == bc0 and col + n <= c.b_x
                    got += [(row, col + i) for i in range(n)]
                    slot += n
                want = [(br0 + r, bc0 + i) for r in range(nbr)
                        for i in range(nbc)] if nbc else []
                assert got == want
            assert slot <= tiles.stage_blocks


def test_sampling_paths():
    """Which geometries take K11's shift path and K12's box cells, and
    K11's channel-ordered records."""
    pow2 = {name: dense_fast.pow2_sampling(_geom(*GEOMS[name]))
            for name in GEOMS}
    assert [n for n, v in pow2.items() if not v] == [
        "411", "nondividing", "nondividing wide", "nondividing tall"]
    cells = {name: encode_tiles(_geom(*GEOMS[name])).cell
             for name in ENCODE_GEOMS}
    assert cells == {"420": (2, 2), "422": (1, 2), "444": (1, 1),
                     "gray": (1, 1), "h1v2": (2, 1), "411": (0, 0),
                     "cid312": (0, 0)}
    g = _geom(*GEOMS["cid312"])
    rec = comp_records(g, "decode")
    np.testing.assert_array_equal(dense_fast.channel_records(g)[:3],
                                  rec[[1, 2, 0]])
    assert (dense_fast.channel_records(g)[3] == 0).all()


def encode_kernel_model(frame, qtables, geom):
    """K12 tile by tile as csrc/dense_fast.cu computes it: a tile of
    ``mcus`` MCUs (``encode_tiles``); its samples a box cell at a time
    where ``box_cell`` gives one (each pixel converted once: YCbCr inside
    the true window, the raw channel outside; a 1 x 1 box's sample the
    value - shift, the cell's box sum yy outer, xx inner, from 0, times
    1 / its size - shift), else a sample at a time (the box sum, then the
    division); blocks in stage order, FDCT'd and quantized with the plain
    versions' ops, then stored as whole blocks by ``block_stores``.
    Every output block is stored exactly once."""
    tiles = encode_tiles(geom)
    rec = comp_records(geom, "encode")
    shift = float(1 << (geom.precision - 1))
    tb = sum(c.n_blocks for c in geom.components)
    out = torch.zeros(tb, 64, dtype=torch.int32)
    writes = torch.zeros(tb, dtype=torch.int32)
    cy, cx = tiles.cell
    for my in range(geom.m_y):
        for tx in range(tiles.tiles_x):
            n = min(tiles.mcus, geom.m_x - tx * tiles.mcus)
            y0, x0 = my * tiles.mcu_h, tx * tiles.mcus * tiles.mcu_w
            px = frame[y0:y0 + tiles.mcu_h, x0:x0 + n * tiles.mcu_w]
            inside = ((torch.arange(y0, y0 + px.shape[0]) < geom.height)
                      [:, None] & (torch.arange(x0, x0 + px.shape[1])
                                   < geom.width)[None, :])
            ycc = torch.where(inside[..., None], rgb_to_ycc(px,
                                                            geom.precision),
                              px)
            stage = []
            for j, c in enumerate(geom.components):
                sy, sx = int(rec[j, 2]), int(rec[j, 3])
                if (sy, sx) == (1, 1):
                    samples = ycc[..., j] - shift
                else:
                    if cy:  # the tile's cells: (sy, sx) is the cell
                        assert (sy, sx) == (cy, cx)
                    acc = torch.zeros(8 * c.v, 8 * n * c.h)
                    for yy in range(sy):
                        for xx in range(sx):
                            acc = acc + ycc[yy::sy, xx::sx, j]
                    samples = (acc * (1.0 / (sy * sx)) if cy
                               else acc / float(sy * sx)) - shift
                stage.append(samples.reshape(c.v, 8, n * c.h, 8).permute(
                    0, 2, 1, 3).reshape(-1, 8, 8))
            tq = [int(rec[j, 6]) for j, c in enumerate(geom.components)
                  for _ in range(n * c.h * c.v)]
            q = quantize(fdct8x8_matmul(torch.cat(stage)).reshape(-1, 64),
                         qtables[tq])
            for at, row, blocks in block_stores(geom, tiles, my, tx):
                out[row:row + blocks] = q[at:at + blocks]
                writes[row:row + blocks] += 1
    assert (writes == 1).all()
    return out


ENCODE_GEOMS = ["420", "422", "444", "gray", "h1v2", "411", "cid312"]


@pytest.mark.parametrize("name", ENCODE_GEOMS)
def test_encode_kernel_model(name):
    comps, height, width = GEOMS[name]
    g = _geom(comps, height, width, 12 if name == "444" else 8)
    rng = np.random.default_rng(len(name))
    hi = 4095 if g.precision == 12 else 255
    frame = torch.from_numpy(rng.uniform(0, hi, (g.size_y, g.size_x, g.nf))
                             .astype(np.float32))
    qt = torch.from_numpy(rng.integers(1, 60, (4, 64)).astype(np.int32))
    want = encode_frame_fast_ref(frame, qt, g)
    torch.testing.assert_close(encode_kernel_model(frame, qt, g), want,
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", ENCODE_GEOMS + ["420 1080p"])
def test_block_stores_cover_every_block(name):
    """K12 stores every block of its output exactly once, each tile's
    stores reading its stage blocks 0 .. n * bpm once each."""
    g = _geom(*GEOMS[name])
    tiles = encode_tiles(g)
    assert tiles.mcus * tiles.bpm <= dense_fast.ENCODE_TILE_BLOCKS
    writes = np.zeros(sum(c.n_blocks for c in g.components), np.int32)
    for my in range(g.m_y):
        for tx in range(tiles.tiles_x):
            n = min(tiles.mcus, g.m_x - tx * tiles.mcus)
            read = np.zeros(n * tiles.bpm, np.int32)
            for at, row, blocks in block_stores(g, tiles, my, tx):
                read[at:at + blocks] += 1
                writes[row:row + blocks] += 1
            assert (read == 1).all()
    assert (writes == 1).all()
    if name == "420 1080p":  # 3 CTAs of the kernel fit an SM
        assert 3 * dense_fast.encode_smem(tiles, 3) <= 227 * 1024


def test_wrappers_dispatch():
    """A CPU tensor runs the plain version and counts no launch; another
    device raises; 2 components raise ValueError before anything runs,
    and the encoder refuses a sampling that does not divide."""
    g = _geom(*GEOMS["420"])
    tb = sum(c.n_blocks for c in g.components)
    coeffs = torch.zeros(tb, 64, dtype=torch.int32)
    qt = torch.ones(4, 64, dtype=torch.int32)
    before = (decode_frame_fast.launches, encode_frame_fast.launches)
    px = decode_frame_fast(coeffs, qt, g)
    assert px.shape == (g.size_y, g.size_x, 3) and (px == 128).all()
    frame = torch.full((g.size_y, g.size_x, 3), 128.0)
    assert (encode_frame_fast(frame, qt, g) == 0).all()
    assert (decode_frame_fast.launches, encode_frame_fast.launches) == before
    with pytest.raises(ValueError, match="device"):
        decode_frame_fast(coeffs.to("meta"), qt.to("meta"), g)
    with pytest.raises(ValueError, match="device"):
        encode_frame_fast(frame.to("meta"), qt.to("meta"), g)
    two = _geom(((1, 1, 1, 0), (2, 1, 1, 1)), 16, 16)
    for dev in ("cpu", "meta"):
        c2 = torch.zeros(8, 64, dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="component count 2"):
            decode_frame_fast(c2, qt.to(dev), two)
        with pytest.raises(ValueError, match="1 or 3 components"):
            encode_frame_fast(torch.zeros(16, 16, 2, device=dev),
                              qt.to(dev), two)
    with pytest.raises(ValueError, match="does not divide"):
        encode_tiles(_geom(*GEOMS["nondividing"]))
    # the JAX package raises the same on two components
    with pytest.raises(ValueError, match="component count 2"):
        to_rgb(torch.zeros(2, 2), 8)
    assert dense_fast.COMP_INTS == 8 and dense_fast.C_MAX == 4


@pytest.mark.parametrize("name, python", [
    ("COMP_INTS", "COMP_INTS"), ("C_MAX", "C_MAX"), ("BP", "BLOCK_FLOATS"),
    ("STAGES", "STAGES"), ("HEAD_BYTES", "HEAD_BYTES")])
def test_source_constants_match_python(name, python):
    """csrc/dense_fast.cu's layout constants equal the Python side that
    sizes the CTAs' shared memory (``decode_smem``, ``encode_smem``) and
    packs the records: the check the library makes on load
    (``kernels._check_layouts``), here on the source text."""
    src = (Path(dense_fast.__file__).parents[1] / "csrc" / "dense_fast.cu"
           ).read_text()
    m = re.search(rf"constexpr int {name} = ([0-9 +*]+);", src)
    assert m, name
    assert eval(m.group(1), {"__builtins__": {}}) == getattr(dense_fast,
                                                             python)
