"""Plain PyTorch versions of the encode-side entropy kernels.

``encode_scan_ref`` and ``hist_from_blocks_ref`` are what the segment
encode and histogram kernels of ``csrc/encode_scan.cu`` compute; the CPU
path runs them, and the chip check holds each kernel against them on
the card.  Their semantics are those of the JAX package's
``entropy/encode_jax.encode_scan_device3`` and ``hist_from_blocks``,
symbol for symbol (missing codes included), so the CPU tests hold them
against those directly.

Both take quantized blocks ``zz`` [B, 64] int32 in zig-zag order with
the DC already differential, rows in any ("natural") order, and per-row
table ids into stacked code tables ``ehufco``/``ehufsi`` [T, 256].

``encode_scan_ref`` lays every block's items (DC, then per nonzero its
ZRLs and its (run, cat) symbol, then EOB) out in a [B, n_items] grid
sized from the batch's true maximum, takes exclusive prefix sums of the
item lengths within blocks and of the block lengths within segments
(bitstream order), and adds each item's bits into the one or two u32
words it covers.  Bits never overlap, so the adds are ORs.
"""

from __future__ import annotations

from typing import Dict

import torch

_I64 = torch.int64


def _category(v: torch.Tensor) -> torch.Tensor:
    """encode_cat_jax: #{k < 16 : |v| >= 2^k} (int32 abs wraps as in JAX)."""
    mag = v.abs()
    cat = torch.zeros_like(v)
    for k in range(16):
        cat += (mag >= (1 << k)).to(v.dtype)
    return cat


def _extra(v: torch.Tensor, cat: torch.Tensor) -> torch.Tensor:
    """(v - 1) & mask for negative values, v & mask otherwise (int64)."""
    v = v.to(_I64)
    adj = torch.where(v < 0, v - 1, v)
    return adj & ((torch.ones_like(adj) << cat.to(_I64)) - 1)


def block_symbols(zz: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-block symbol structure of [B, 64] zig-zag blocks (int64):

    ``dcat``/``dext`` [B]; per AC position [B, 63]: ``nz``, ``sym``
    ((run << 4) | cat), ``cat``, ``ext``, ``n_zrl`` (ZRLs emitted before
    that nonzero); per block [B]: ``zrl`` total and ``eob`` (0/1).
    """
    dc = zz[:, 0]
    acs = zz[:, 1:]
    b = zz.shape[0]
    nz = acs != 0
    pos = torch.arange(1, 64, device=zz.device, dtype=_I64)[None, :]
    last_nz = torch.cummax(torch.where(nz, pos, torch.zeros_like(pos)),
                           dim=1).values
    prev_nz = torch.cat([torch.zeros(b, 1, dtype=_I64, device=zz.device),
                         last_nz[:, :-1]], dim=1)
    gap = pos - prev_nz - 1
    zero = torch.zeros_like(gap)
    n_zrl = torch.where(nz, gap // 16, zero)
    run = torch.where(nz, gap % 16, zero)
    cat = _category(acs).to(_I64)
    dcat = _category(dc).to(_I64)
    has_any = nz.any(dim=1)
    eob = (~(has_any & (last_nz[:, -1] == 63))).to(_I64)
    return {
        "dcat": dcat,
        "dext": _extra(dc, dcat),
        "nz": nz,
        "sym": (run << 4) | cat,
        "cat": cat,
        "ext": _extra(acs, cat),
        "n_zrl": n_zrl,
        "zrl": n_zrl.sum(dim=1),
        "eob": eob,
    }


def hist_from_blocks_ref(zz: torch.Tensor, dc_tab: torch.Tensor,
                         ac_tab: torch.Tensor, T: int) -> torch.Tensor:
    """Per-table symbol histogram -> [T, 256] int32 (exact integers)."""
    s = block_symbols(zz)
    dct = dc_tab.to(_I64)
    act = ac_tab.to(_I64)
    hist = torch.zeros(T * 256, dtype=_I64, device=zz.device)
    hist.index_add_(0, dct * 256 + s["dcat"], torch.ones_like(dct))
    ac_idx = (act[:, None] * 256 + s["sym"])[s["nz"]]
    hist.index_add_(0, ac_idx, torch.ones_like(ac_idx))
    hist.index_add_(0, act * 256 + 0xF0, s["zrl"])
    hist.index_add_(0, act * 256, s["eob"])
    return hist.reshape(T, 256).to(torch.int32)


def segment_layout(blk_bits_v: torch.Tensor, seg_of: torch.Tensor,
                   n_segments: int):
    """Block bits in bitstream order -> (dst_bit [B] int64 bit offset of
    each block in the tight word stream, seg_wbase [n_segments] int64 first
    word of each segment, seg_bits [n_segments] int64, total words).

    Each segment starts on a fresh word; blocks follow each other bit by
    bit inside it.  The encode walk and compaction of
    ``csrc/encode_scan.cu`` lay the stream out the same way without the
    per-block offsets.
    """
    bits = blk_bits_v.to(_I64)
    seg = seg_of.to(_I64)
    seg_bits = torch.zeros(n_segments, dtype=_I64, device=bits.device)
    seg_bits.index_add_(0, seg, bits)
    seg_bitbase = torch.cumsum(seg_bits, 0) - seg_bits
    g = torch.cumsum(bits, 0) - bits
    nw = (seg_bits + 31) >> 5
    cum_nw = torch.cumsum(nw, 0)
    seg_wbase = cum_nw - nw
    dst = seg_wbase[seg] * 32 + (g - seg_bitbase[seg])
    total = int(cum_nw[-1]) if n_segments else 0
    return dst, seg_wbase, seg_bits, total


def _to_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 holding the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def encode_scan_ref(zz: torch.Tensor, order: torch.Tensor,
                    seg_of: torch.Tensor, dc_tab: torch.Tensor,
                    ac_tab: torch.Tensor, ehufco: torch.Tensor,
                    ehufsi: torch.Tensor, n_segments: int):
    """Plain PyTorch version of the segment encode kernel, on any device.

    ``order`` [B]: bitstream position -> zz row; ``seg_of`` [B]
    nondecreasing segment of each bitstream position; ``dc_tab``/``ac_tab``
    [B] per zz row.  -> (words [W] int32 (u32 bits, MSB first), seg_wbase
    [n_segments] int64, seg_bits [n_segments] int64, missing 0-d bool).
    """
    dev = zz.device
    b = zz.shape[0]
    s = block_symbols(zz)
    co = ehufco.to(_I64)
    si = ehufsi.to(_I64)
    dct = dc_tab.to(_I64)
    act = ac_tab.to(_I64)
    nz = s["nz"]

    # Item grid: index of each nonzero's symbol = DC + all items up to it.
    per_pos = s["n_zrl"] + nz.to(_I64)
    sym_idx = torch.cumsum(per_pos, dim=1)
    n_items = 1 + per_pos.sum(dim=1) + s["eob"]
    width = int(n_items.max()) if b else 1
    lens = torch.zeros(b, width, dtype=_I64, device=dev)
    vals = torch.zeros(b, width, dtype=_I64, device=dev)
    sizes = torch.ones(b, width, dtype=_I64, device=dev)  # 0 = missing
    rows = torch.arange(b, device=dev)

    def put(r, idx, size, code, nbits, extra):
        lens[r, idx] = size + nbits
        vals[r, idx] = (code << nbits) | extra
        sizes[r, idx] = size

    zero = torch.zeros_like(dct)
    put(rows, zero, si[dct, s["dcat"]], co[dct, s["dcat"]], s["dcat"],
        s["dext"])
    act2 = act[:, None].expand_as(s["sym"])
    r2 = rows[:, None].expand_as(s["sym"])
    put(r2[nz], sym_idx[nz], si[act2, s["sym"]][nz], co[act2, s["sym"]][nz],
        s["cat"][nz], s["ext"][nz])
    for z in range(1, 4):
        m = s["n_zrl"] >= z
        a = act2[m]
        zeros = torch.zeros_like(a)
        put(r2[m], sym_idx[m] - z, si[a, 0xF0], co[a, 0xF0], zeros, zeros)
    e = s["eob"] > 0
    a = act[e]
    zeros = torch.zeros_like(a)
    put(rows[e], n_items[e] - 1, si[a, 0], co[a, 0], zeros, zeros)
    valid = torch.arange(width, device=dev)[None, :] < n_items[:, None]
    missing = (valid & (sizes == 0)).any()

    blk_bits = lens.sum(dim=1)
    order64 = order.to(_I64)
    dst_v, seg_wbase, seg_bits, total = segment_layout(
        blk_bits[order64], seg_of, n_segments)
    dst = torch.empty_like(dst_v)
    dst[order64] = dst_v

    # Each item (<= 32 bits) covers the word of its first bit and, when it
    # runs past that word's end, the next one.
    pos = dst[:, None] + torch.cumsum(lens, dim=1) - lens
    live = lens > 0
    w = (pos >> 5)[live]
    end = (pos & 31)[live] + lens[live]
    v = vals[live]
    one_word = end <= 32
    hi = torch.where(one_word, v << (32 - end).clamp(min=0),
                     v >> (end - 32).clamp(min=0))
    lo = torch.where(one_word, torch.zeros_like(v),
                     (v << (64 - end).clamp(max=63)) & 0xFFFFFFFF)
    flat = torch.zeros(total + 1, dtype=_I64, device=dev)
    flat.index_add_(0, w, hi)
    flat.index_add_(0, w + 1, lo)
    return _to_u32_bits(flat[:total]), seg_wbase, seg_bits, missing
