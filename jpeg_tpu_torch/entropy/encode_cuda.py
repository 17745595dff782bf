"""Segment Huffman encode and symbol histogram on the card.

``encode_scan`` is the port of the JAX package's device entropy encode
``entropy/encode_jax.encode_scan_device3`` (plus the transfer compaction
``device_encode._compact_segment_words``): on a CUDA tensor it launches
the hand-written kernels of ``csrc/encode_scan.cu`` -- an encode walk
(one warp per restart segment, or per piece of up to 256 blocks of a
long one, each into its own region of a scratch buffer), a layout of the
pieces, one ``torch.cumsum`` of the segments' word counts and a
compaction into the tight stream -- with no host sync in between; on a
CPU tensor it runs ``encode_torch.encode_scan_ref``.  It writes one
tight word stream at exact offsets into a buffer of ``word_capacity``
words, so none of the JAX engine's static capacities (item slots,
nonzero cap, words per segment or per block) exist here, and the
stream's length stays on the device until the caller pulls it.

``block_histogram`` is the port of ``encode_jax.hist_from_blocks`` (the
optimize dry pass): the histogram kernel of ``csrc/encode_scan.cu``
(one warp per block, a persistent grid) on a CUDA tensor,
``encode_torch.hist_from_blocks_ref`` on a CPU tensor; either adds into a
caller's histogram (``out=``), so a batch keeps one accumulator.  Rows
of the stacked tables offset by each block's frame give one histogram
and one set of code tables a frame (``DeviceEncoder`` with per-frame
tables).

Each wrapper counts its kernel launches in ``<wrapper>.launches`` and
raises on anything the kernel does not take, and on any CUDA error.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import check_tensor, cuda_stream
from .encode_torch import encode_scan_ref, hist_from_blocks_ref

T_MAX = 32  # stacked code tables (four a frame, 8 frames); csrc/encode_scan.cu
# The most words one block takes: a DC item and 63 AC items of at most
# 16 code bits and 16 extra bits each (no EOB after a nonzero position
# 63), 2048 bits; csrc/encode_scan.cu BLOCK_WORDS.
BLOCK_WORDS = 64
I32 = (torch.int32,)


def word_capacity(n_blocks: int) -> int:
    """Words that hold the stream of any ``n_blocks`` blocks, known on the
    host without the card: every segment starts on a fresh word, and a
    segment's blocks take at most ``BLOCK_WORDS`` words each."""
    return BLOCK_WORDS * n_blocks


def _check_blocks(zz: torch.Tensor, T: int) -> torch.device:
    dev = zz.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if zz.dim() != 2 or zz.shape[1] != 64:
        raise ValueError(f"zz must be [B, 64], got {tuple(zz.shape)}")
    check_tensor("zz", zz, I32, zz.shape, dev)
    if not 0 < T <= T_MAX:
        raise ValueError(f"{T} code tables; the kernels take 1..{T_MAX}")
    return dev


def encode_scan(zz: torch.Tensor, order: torch.Tensor, seg_of: torch.Tensor,
                dc_tab: torch.Tensor, ac_tab: torch.Tensor,
                ehufco: torch.Tensor, ehufsi: torch.Tensor, n_segments: int):
    """Huffman-encode ``zz`` [B, 64] into restart segments.

    -> (words [W] int32 (u32 bits, MSB first; segment s starts at word
    ``seg_wbase[s]``), seg_wbase [n_segments] int64, seg_bits
    [n_segments] int64, missing 0-d bool: some symbol had no code,
    n_words 0-d int64): the stream is ``words[:n_words]``.  On the card
    ``words`` is a capacity buffer of ``word_capacity(B)`` words (256
    bytes a block, as large as ``zz``) and ``missing`` and ``n_words``
    stay there (nothing syncs with the host): trim it to ``n_words``, or
    copy the stream out and drop it, before keeping it.  The encode walk
    writes into a scratch buffer of the same size, kept per device and
    stream (``_scratch``).  On the CPU ``words`` is the stream itself.
    See ``encode_torch.encode_scan_ref`` for the arguments; code lengths
    are at most 16 bits, as a JPEG table's are.
    """
    if zz.device.type == "cpu":
        words, seg_wbase, seg_bits, missing = encode_scan_ref(
            zz, order, seg_of, dc_tab, ac_tab, ehufco, ehufsi, n_segments)
        return (words, seg_wbase, seg_bits, missing,
                torch.tensor(words.numel(), dtype=torch.int64))
    T = int(ehufco.shape[0])
    dev = _check_blocks(zz, T)
    b = int(zz.shape[0])
    for name, t in (("order", order), ("seg_of", seg_of),
                    ("dc_tab", dc_tab), ("ac_tab", ac_tab)):
        check_tensor(name, t, I32, (b,), dev)
    check_tensor("ehufco", ehufco, I32, (T, 256), dev)
    check_tensor("ehufsi", ehufsi, I32, (T, 256), dev)
    if b >= 1 << 31:
        raise ValueError("too many blocks for int32 indices")

    from ..kernels import load_library

    lib = load_library().lib
    n = int(n_segments)
    i64 = dict(dtype=torch.int64, device=dev)
    seg_first = torch.empty(n, dtype=torch.int32, device=dev)
    seg_bits = torch.empty(n, **i64)
    seg_rec = torch.empty(n, **i64)  # words | missing << 40 per segment
    n_pieces = lib.jt_encode_scan_pieces(b, n)
    piece_rec = torch.empty(n_pieces, **i64)  # bits | missing << 40
    piece_off = torch.empty(n_pieces - n, **i64)
    seg_wbase = torch.empty(n, **i64)
    words = torch.empty(word_capacity(b), dtype=torch.int32, device=dev)
    if n == 0:
        return (words, seg_wbase, seg_bits,
                torch.zeros((), dtype=torch.bool, device=dev),
                torch.zeros((), **i64))
    scratch = _scratch(dev, word_capacity(b))  # BLOCK_WORDS words per block
    n_words = torch.empty((), **i64)
    missing = torch.empty((), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = cuda_stream(dev)
        rc = lib.jt_encode_segments(
            zz.data_ptr(), order.data_ptr(), seg_of.data_ptr(),
            dc_tab.data_ptr(), ac_tab.data_ptr(), ehufco.data_ptr(),
            ehufsi.data_ptr(), T, b, n, scratch.data_ptr(),
            seg_first.data_ptr(), piece_rec.data_ptr(), piece_off.data_ptr(),
            seg_bits.data_ptr(), seg_rec.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"encode_scan encode walk failed: CUDA error "
                               f"{rc}")
        cum = torch.cumsum(seg_rec, 0)
        rc = lib.jt_compact_segments(
            scratch.data_ptr(), seg_of.data_ptr(), seg_first.data_ptr(),
            piece_rec.data_ptr(), piece_off.data_ptr(), seg_rec.data_ptr(),
            cum.data_ptr(), b, n, words.data_ptr(), seg_wbase.data_ptr(),
            n_words.data_ptr(), missing.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"encode_scan compaction failed: CUDA error {rc}")
    encode_scan.launches += 1
    return words, seg_wbase, seg_bits, missing, n_words


encode_scan.launches = 0
# (device, stream) -> the encode walk's scratch words; calls on one stream
# run in order, so they can share it.
_SCRATCH: dict = {}


def _scratch(dev: torch.device, n: int) -> torch.Tensor:
    """``n`` scratch words on ``dev`` for the current stream, grown as
    needed and kept between calls."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n:
        _SCRATCH[key] = buf = None  # free the old buffer first
        buf = _SCRATCH[key] = torch.empty(n, dtype=torch.int32, device=dev)
    return buf[:n]


def block_histogram(zz: torch.Tensor, dc_tab: torch.Tensor,
                    ac_tab: torch.Tensor, T: int,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-table symbol counts of ``zz`` [B, 64] -> [T, 256] int32: a new
    histogram, or ``out`` (int32 [T, 256] on ``zz``'s device) with the
    counts added into it."""
    if out is not None:
        check_tensor("out", out, I32, (T, 256), zz.device)
    if zz.device.type == "cpu":
        hist = hist_from_blocks_ref(zz, dc_tab, ac_tab, T)
        return hist if out is None else out.add_(hist)
    dev = _check_blocks(zz, T)
    b = int(zz.shape[0])
    check_tensor("dc_tab", dc_tab, I32, (b,), dev)
    check_tensor("ac_tab", ac_tab, I32, (b,), dev)
    if out is None:
        out = torch.zeros(T, 256, dtype=torch.int32, device=dev)

    from ..kernels import load_library

    lib = load_library().lib
    with torch.cuda.device(dev):
        rc = lib.jt_hist_blocks(zz.data_ptr(), dc_tab.data_ptr(),
                                ac_tab.data_ptr(), T, b, out.data_ptr(),
                                cuda_stream(dev))
    if rc != 0:
        raise RuntimeError(f"block_histogram launch failed: CUDA error {rc}")
    block_histogram.launches += 1
    return out


block_histogram.launches = 0


def visit_zz_and_tables(planes, geom, info, tables, ri: int = 0):
    """Shared host prep for the device/native entropy encoders.

    Returns (zz [B,64] int32 visit order with differential DC, dc_tab,
    ac_tab, seg_of [B] int32, ehufco, ehufsi [T,256] int32).
    """
    from ..constants import ZIGZAG
    from .encode import build_visit_order

    comp_idx, block_seq = build_visit_order(geom, info)
    stacked = [np.asarray(planes[cid], np.int64) for cid in info.component_ids]
    zz = np.empty((comp_idx.size, 64), np.int64)
    for j in range(len(info.component_ids)):
        sel = comp_idx == j
        zz[sel] = stacked[j][block_seq[sel]][:, ZIGZAG]

    if info.ns == 1:
        c0 = geom.by_id(info.component_ids[0])
        bpm = c0.h * c0.v
    else:
        bpm = comp_idx.size // geom.n_mcus
    mcu_of = np.arange(comp_idx.size) // bpm
    seg_of = mcu_of // ri if ri else np.zeros_like(mcu_of)

    # Differential DC per component with per-segment predictor reset.
    dc = zz[:, 0].copy()
    for j in range(len(info.component_ids)):
        sel = np.nonzero(comp_idx == j)[0]
        seq = dc[sel]
        prev = np.concatenate(([0], seq[:-1]))
        iv = seg_of[sel]
        first = np.concatenate(([True], iv[1:] != iv[:-1]))
        zz[sel, 0] = np.where(first, seq, seq - prev)

    keys = []
    for td in info.td:
        if (0, td) not in keys:
            keys.append((0, td))
    for ta in info.ta:
        if (1, ta) not in keys:
            keys.append((1, ta))
    tmap = {k: i for i, k in enumerate(keys)}
    ehufco = np.stack([tables[k].ehufco for k in keys]).astype(np.int32)
    ehufsi = np.stack([tables[k].ehufsi for k in keys]).astype(np.int32)
    td = np.asarray([tmap[(0, info.td[j])] for j in range(info.ns)])
    ta = np.asarray([tmap[(1, info.ta[j])] for j in range(info.ns)])
    return (
        zz.astype(np.int32),
        td[comp_idx].astype(np.int32),
        ta[comp_idx].astype(np.int32),
        seg_of.astype(np.int32),
        ehufco,
        ehufsi,
    )


def pack_scan_device(planes, geom, info, tables, ri: int, device):
    """Device entropy encode: planes -> stuffed ECS segments.

    Mirrors ``entropy.encode.pack_scan`` (byte-identical output), with the
    symbols coded and packed by ``encode_scan`` on ``device``; the host
    lays out the visit order and trims, pads and byte-stuffs each segment.
    """
    from ..errors import UnsupportedError

    zz, dct, act, seg_of, ehufco, ehufsi = visit_zz_and_tables(
        planes, geom, info, tables, ri
    )
    n_segments = int(seg_of.max()) + 1
    dev = torch.device(device)
    words, seg_wbase, seg_bits, missing, n_words = encode_scan(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for a in (zz, np.arange(zz.shape[0], dtype=np.int32), seg_of, dct,
                    act, ehufco, ehufsi)),
        n_segments,
    )
    if bool(missing):
        # Same hard failure as the host packer / reference value_to_vlc.
        raise UnsupportedError(
            "a symbol has no code in the selected Huffman table "
            "(content exceeds table range; use optimized tables)"
        )
    words = words[:int(n_words)].cpu().numpy().view(np.uint32)
    base = seg_wbase.cpu().numpy()
    bits = seg_bits.cpu().numpy()
    return [finalize_segment(words[base[s]:base[s] + (bits[s] + 31) // 32],
                             int(bits[s])) for s in range(n_segments)]


def finalize_segment(words: np.ndarray, total_bits: int) -> bytes:
    """Host-side: trim, 1-pad the tail byte (flush_bits) and byte-stuff."""
    nbytes = (int(total_bits) + 7) // 8
    by = words.astype(">u4").tobytes()[:nbytes]
    arr = np.frombuffer(by, np.uint8).copy()
    pad = nbytes * 8 - int(total_bits)
    if pad:
        arr[-1] |= (1 << pad) - 1
    is_ff = arr == 0xFF
    if is_ff.any():
        out = np.zeros(arr.size + int(is_ff.sum()), dtype=np.uint8)
        dst = np.arange(arr.size) + np.cumsum(is_ff) - is_ff
        out[dst] = arr
        return out.tobytes()
    return arr.tobytes()
