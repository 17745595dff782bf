"""Segment Huffman encode and symbol histogram on the card.

``encode_scan`` is the port of the JAX package's device entropy encode
``entropy/encode_jax.encode_scan_device3`` (plus the transfer compaction
``device_encode._compact_segment_words``): on a CUDA tensor it launches
the hand-written kernels of ``csrc/encode_scan.cu`` (count bits, then
pack), with the segmented prefix sums between them taken by
``encode_torch.segment_layout``; on a CPU tensor it runs
``encode_torch.encode_scan_ref``.  It writes one tight word stream at
exact offsets, so none of the JAX engine's static capacities (item
slots, nonzero cap, words per segment or per block) exist here.

``block_histogram`` is the port of ``encode_jax.hist_from_blocks`` (the
optimize=True dry pass): the histogram kernel of ``csrc/encode_scan.cu``
(the same symbol walk) on a CUDA tensor, ``encode_torch.hist_from_blocks_ref``
on a CPU tensor.

Each wrapper counts its kernel launches in ``<wrapper>.launches`` and
raises on anything the kernel does not take, and on any CUDA error.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import check_tensor
from .encode_torch import encode_scan_ref, hist_from_blocks_ref, segment_layout

T_MAX = 8  # stacked code tables; csrc/encode_scan.cu
I32 = (torch.int32,)


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


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def encode_scan(zz: torch.Tensor, order: torch.Tensor, seg_of: torch.Tensor,
                dc_tab: torch.Tensor, ac_tab: torch.Tensor,
                ehufco: torch.Tensor, ehufsi: torch.Tensor, n_segments: int):
    """Huffman-encode ``zz`` [B, 64] into restart segments.

    -> (words [W] int32 (u32 bits, MSB first; segment s starts at word
    ``seg_wbase[s]``), seg_wbase [n_segments] int64, seg_bits
    [n_segments] int64, missing 0-d bool: some symbol had no code).
    See ``encode_torch.encode_scan_ref`` for the arguments.
    """
    if zz.device.type == "cpu":
        return encode_scan_ref(zz, order, seg_of, dc_tab, ac_tab, ehufco,
                               ehufsi, n_segments)
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
    blk_bits = torch.empty(b, dtype=torch.int32, device=dev)
    missing = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.jt_encode_bits(
            zz.data_ptr(), order.data_ptr(), dc_tab.data_ptr(),
            ac_tab.data_ptr(), ehufco.data_ptr(), ehufsi.data_ptr(), T, b,
            blk_bits.data_ptr(), missing.data_ptr(), _stream(dev))
        if rc != 0:
            raise RuntimeError(f"encode_scan pass 1 failed: CUDA error {rc}")
        dst, seg_wbase, seg_bits, total = segment_layout(blk_bits, seg_of,
                                                         n_segments)
        words = torch.zeros(max(total, 1), dtype=torch.int32, device=dev)
        rc = lib.jt_encode_pack(
            zz.data_ptr(), order.data_ptr(), dc_tab.data_ptr(),
            ac_tab.data_ptr(), ehufco.data_ptr(), ehufsi.data_ptr(), T, b,
            dst.data_ptr(), words.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"encode_scan pass 2 failed: CUDA error {rc}")
    encode_scan.launches += 1
    return words[:total], seg_wbase, seg_bits, missing[0] != 0


encode_scan.launches = 0


def block_histogram(zz: torch.Tensor, dc_tab: torch.Tensor,
                    ac_tab: torch.Tensor, T: int) -> torch.Tensor:
    """Per-table symbol counts of ``zz`` [B, 64] -> [T, 256] int32."""
    if zz.device.type == "cpu":
        return hist_from_blocks_ref(zz, dc_tab, ac_tab, T)
    dev = _check_blocks(zz, T)
    b = int(zz.shape[0])
    check_tensor("dc_tab", dc_tab, I32, (b,), dev)
    check_tensor("ac_tab", ac_tab, I32, (b,), dev)

    from ..kernels import load_library

    lib = load_library().lib
    hist = torch.zeros(T, 256, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.jt_hist_blocks(zz.data_ptr(), dc_tab.data_ptr(),
                                ac_tab.data_ptr(), T, b, hist.data_ptr(),
                                _stream(dev))
    if rc != 0:
        raise RuntimeError(f"block_histogram launch failed: CUDA error {rc}")
    block_histogram.launches += 1
    return hist


block_histogram.launches = 0
