"""PyTorch port: what the encode kernels' wrappers lay out on the host (CPU).

* ``encode_cuda.word_capacity``, the word buffer ``encode_scan`` fills on
  the card without asking it for the stream's length: it holds the plain
  version's stream of worst-case blocks at 8 and 12 bits, and it is
  tight for blocks of 64 nonzero coefficients of the capped category 16
  under 16-bit codes;
* ``encode_dense.tile_plan``, the tiles of MCUs the dense kernel
  encodes, through ``tile_window`` and ``tile_blocks`` below, which
  repeat the kernel's index arithmetic: each tile stages the pixels of
  ``pixels_to_zz_ref``'s edge-replicated frame (``_padded``), every block
  of the frame belongs to exactly one tile, and each block's samples lie
  inside its tile;
* the return contract ``encode_scan`` gained (the stream is
  ``words[:n_words]``), through ``DeviceEncoder.pack``: the blocks of
  jpeg_tpu's encoded frames, packed by the port, give jpeg_tpu's bytes.
"""

import numpy as np
import pytest
import torch

from jpeg_tpu_torch.encoder import EncodeParams
from jpeg_tpu_torch.entropy.encode_cuda import encode_scan, word_capacity
from jpeg_tpu_torch.geometry import Component, FrameGeometry, with_block_grid
from jpeg_tpu_torch.entropy.encode_torch import encode_scan_ref
from jpeg_tpu_torch.models.device_encode import DeviceEncoder
from jpeg_tpu_torch.models.encode_dense import (
    TILE_BLOCKS,
    TilePlan,
    _padded,
    tile_plan,
)
from jpeg_tpu_torch.utils import synth
from test_torch_encode import _blocks_of, _encoders, _frames


def _port_encoder(comps, h, v, height, width, precision, ri=2):
    return DeviceEncoder.for_config(
        height, width, comps,
        EncodeParams(h=h, v=v, quality=80, optimize=False,
                     restart_interval=ri, exact=False),
        precision=precision, device="cpu")


def _long_codes(T: int):
    """Code tables of 16-bit codes for every symbol (not prefix-free:
    the segment encode only packs them)."""
    sym = torch.arange(T * 256, dtype=torch.int64).reshape(T, 256)
    return ((sym * 40503) & 0xFFFF).to(torch.int32), \
        torch.full((T, 256), 16, dtype=torch.int32)


@pytest.mark.parametrize("precision,dc_cat,ac_cat",
                         [(8, 11, 10), (12, 15, 14), (12, 16, 16)])
def test_word_capacity_holds_worst_blocks(precision, dc_cat, ac_cat):
    enc = _port_encoder(3, 2, 2, 48, 64, precision)
    frames = 2
    zz = torch.from_numpy(synth.worst_blocks(
        frames * enc.blocks_per_frame, dc_cat, ac_cat))
    order, seg_of, dc_tab, ac_tab = enc.chunk_tables(frames)
    co, si = _long_codes(len(enc.table_keys))
    n_seg = frames * enc.n_segments
    words, _, seg_bits, missing, n_words = encode_scan(
        zz, order, seg_of, dc_tab, ac_tab, co, si, n_seg)
    assert not bool(missing)
    assert int(n_words) == words.numel() <= word_capacity(zz.shape[0])
    per_seg = torch.bincount(seg_of.to(torch.int64), minlength=n_seg)
    assert bool((seg_bits <= 32 * word_capacity(1) * per_seg).all())
    if ac_cat == 16:
        # 64 nonzeros of category 16 under 16-bit codes: 32 bits each,
        # so every block takes exactly its capacity.
        full = zz[::3][:1].expand_as(zz).contiguous()
        assert int((full != 0).sum()) == full.numel()
        out = encode_scan(full, order, seg_of, dc_tab, ac_tab, co, si, n_seg)
        assert int(out[4]) == word_capacity(zz.shape[0])


def test_worst_blocks_shapes():
    zz = synth.worst_blocks(6, 15, 14)
    assert (zz[:, 63] != 0).all() and (zz[0] != 0).all()
    for i in (1, 2, 4, 5):
        zero = np.flatnonzero(zz[i] == 0)
        assert 16 <= zero.size <= 47
        assert (np.diff(zero) == 1).all()  # one run
    assert zz[1, 1] == 0 and zz[2, 1] != 0
    mags = np.abs(zz[zz != 0].astype(np.int64))
    assert mags.min() >= 1 << 13 and np.abs(zz[:, 0]).min() >= 1 << 14


def tile_window(geom: FrameGeometry, plan: TilePlan, tile: int):
    """Tile ``tile`` of a frame -> (MCUs n, source rows [mcu_h], source
    columns [n * mcu_w]): the frame pixels the kernel stages for it, the
    MCU padding replicated from the last row and column."""
    my, tx = divmod(tile, plan.tiles_x)
    n = min(plan.mcus, geom.m_x - tx * plan.mcus)
    y0, x0 = my * plan.mcu_h, tx * plan.mcus * plan.mcu_w
    ys = np.minimum(np.arange(y0, y0 + plan.mcu_h), geom.height - 1)
    xs = np.minimum(np.arange(x0, x0 + n * plan.mcu_w), geom.width - 1)
    return n, ys, xs


def tile_blocks(geom: FrameGeometry, plan: TilePlan, tile: int) -> np.ndarray:
    """The kernel's blocks of tile ``tile`` in its local order -> [nblk, 4]
    int64 (natural row in the frame, component, first padded pixel row
    and column the block's samples cover), by the index
    arithmetic of ``csrc/encode_dense.cu`` (``comp_of``, ``block_row``,
    ``sample_slot``)."""
    my, tx = divmod(tile, plan.tiles_x)
    n = min(plan.mcus, geom.m_x - tx * plan.mcus)
    out = []
    for b in range(n * plan.bpm):
        j = 0
        while j + 1 < len(geom.components) and \
                b >= n * plan.comps[j + 1, 7]:
            j += 1
        h, v, sy, sx, off, b_x, _, first = (int(x) for x in plan.comps[j])
        r, c = divmod(b - n * first, n * h)
        out.append((off + (my * v + r) * b_x + tx * plan.mcus * h + c, j,
                    my * plan.mcu_h + r * 8 * sy,
                    tx * plan.mcus * plan.mcu_w + c * 8 * sx))
    return np.asarray(out, np.int64).reshape(-1, 4)


# name -> (components, h, v, height, width, precision)
TILE_CASES = {
    "420_odd_size": (3, 2, 2, 38, 54, 8),  # padding on both edges
    "420_1080p": (3, 2, 2, 1080, 1920, 8),  # the bench shape
    "422_p12": (3, 2, 1, 32, 48, 12),
    "h1v2_odd_size": (3, 1, 2, 38, 54, 8),  # the box cell (2, 1)
    "444": (3, 1, 1, 24, 40, 8),
    "gray": (1, 1, 1, 37, 45, 8),
    "gray_wide": (1, 1, 1, 16, 600, 8),  # a short last tile per row
}


@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_tile_plan_covers_the_padded_frame(case):
    comps, h, v, height, width, precision = TILE_CASES[case]
    geom = _port_encoder(comps, h, v, height, width, precision).geom
    plan = tile_plan(geom)
    assert plan.mcus * plan.bpm <= TILE_BLOCKS
    # Pixels that hold their own index, edge-replicated by the plain path.
    px = torch.arange(height * width * comps).reshape(1, height, width,
                                                      comps)
    padded = _padded(px, geom)[0].numpy()
    src = px[0].numpy()
    rows = []
    n_blocks = {j: c.n_blocks for j, c in enumerate(
        sorted(geom.components, key=lambda c: c.cid))}
    for tile in range(geom.m_y * plan.tiles_x):
        n, ys, xs = tile_window(geom, plan, tile)
        my, tx = divmod(tile, plan.tiles_x)
        y0, x0 = my * plan.mcu_h, tx * plan.mcus * plan.mcu_w
        y1, x1 = y0 + plan.mcu_h, x0 + n * plan.mcu_w
        np.testing.assert_array_equal(src[ys][:, xs], padded[y0:y1, x0:x1])
        blocks = tile_blocks(geom, plan, tile)
        assert len(blocks) == n * plan.bpm
        for row, j, y, x in blocks:
            _, _, sy, sx, off, b_x, _, _ = plan.comps[j]
            assert off <= row < off + n_blocks[j]
            by, bx = divmod(row - off, b_x)
            assert (y, x) == (by * 8 * sy, bx * 8 * sx)
            assert y0 <= y and y + 8 * sy <= y1
            assert x0 <= x and x + 8 * sx <= x1
        rows.extend(blocks[:, 0].tolist())
    assert sorted(rows) == list(range(sum(n_blocks.values())))


def test_tile_plan_rejects_mixed_boxes():
    # Luma 2x1 and chroma 1x2: boxes (1, 2) and (2, 1), no common cell.
    geom = with_block_grid(FrameGeometry(8, 32, 32, (
        Component(1, 2, 1, 0), Component(2, 1, 2, 1),
        Component(3, 1, 1, 1))))
    with pytest.raises(ValueError, match="boxes"):
        tile_plan(geom)


def test_encode_scan_cpu_return_contract():
    enc = _port_encoder(3, 2, 1, 32, 48, 8, ri=3)
    px = torch.from_numpy(_frames(3, 32, 48, 8, 2, seed=4))
    zz = enc.dense(px)
    args = (zz, *enc.chunk_tables(2), torch.from_numpy(enc.ehufco),
            torch.from_numpy(enc.ehufsi), 2 * enc.n_segments)
    got = encode_scan(*args)
    want = encode_scan_ref(*args)
    words, seg_wbase, seg_bits, missing, n_words = got
    assert n_words.dtype == torch.int64 and n_words.dim() == 0
    assert missing.dtype == torch.bool and missing.dim() == 0
    assert int(n_words) == want[0].numel()
    assert torch.equal(words[:int(n_words)], want[0])
    for a, b in zip(got[1:4], want[1:]):
        assert torch.equal(a, b)
    assert encode_scan.launches == 0  # CPU: the plain version


@pytest.mark.parametrize("ri", [1, 7, 30])  # 30: one segment per frame
def test_pack_reencodes_jax_frames(ri):
    port, ref = _encoders(3, 2, 2, 72, 96, 8, ri)  # 30 MCUs per frame
    px = _frames(3, 72, 96, 8, 3, seed=9)
    want = ref.encode_batch(px, optimize=False)
    blocks = np.concatenate([_blocks_of(w, port.prev_idx) for w in want])
    assert port.pack(torch.from_numpy(blocks)) == want
