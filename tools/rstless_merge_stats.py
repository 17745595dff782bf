"""Count how soon a row's slot variants meet in the RST-less sync (K8).

Run from the repository root, on the CPU (no card needed):

    python3 tools/rstless_merge_stats.py [chunk strip piece]

For the two benchmark frames of chip_smoke's phase 13 (1080p 4:2:0 q75,
``synth.make_frame(0)`` and ``(1)``, encoded by ``DeviceEncoder`` with
one segment a frame and the DRI segment dropped) it cuts each frame into
chunk rows (default 512 B, strip 128 B, piece 32 B: the engine's sizes)
and prints one JSON line a frame:

* ``met_share``: by bit 64, 128, ..., 4,096 of its row, the share of the
  (row, variant) lanes that share a block-start state (bit, slot) with
  another variant of their row, each lane walked with the plain symbol
  step from its row's first bit;
* ``survivors``: K8's groups at the strip mark (``sync_head_ref``): the
  distinct decodes that walk on past the strip, of ``lanes``;
* ``tail_bits_every_variant`` and ``tail_bits_survivors``: the bits the
  tail walk decodes when every lane walks from its row's first bit, and
  when only the survivors walk from their strip marks.  A walk ends at
  its link or its end; a miss is counted to the successor's strip end,
  where the walk stops at the latest.

These are counts of bits and lanes, not times.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from jpeg_tpu_torch.encoder import EncodeParams  # noqa: E402
from jpeg_tpu_torch.entropy import speculative  # noqa: E402
from jpeg_tpu_torch.entropy import speculative_torch as st  # noqa: E402
from jpeg_tpu_torch.entropy.lockstep_torch import _cached_plan  # noqa: E402
from jpeg_tpu_torch.models.device_decode import _rstless_scan  # noqa: E402
from jpeg_tpu_torch.models.device_encode import DeviceEncoder  # noqa: E402
from jpeg_tpu_torch.utils import synth  # noqa: E402

CPU = torch.device("cpu")
THRESHOLDS = [64 << i for i in range(7)]  # 64 .. 4096 bits


def bench_frames():
    """(scan plan, unstuffed segments) of the two phase-13 frames."""
    n_mcus = -(-synth.HEIGHT // 16) * -(-synth.WIDTH // 16)
    enc = DeviceEncoder.for_config(
        synth.HEIGHT, synth.WIDTH, 3,
        EncodeParams(h=2, v=2, quality=75, optimize=False,
                     restart_interval=n_mcus, exact=False), device=CPU)
    px = torch.from_numpy(np.stack([synth.make_frame(s) for s in (0, 1)]))
    frames = [cs.drop_dri(f) for f in
              enc.encode_batch(px, optimize=False, chunk=2)]
    cs0, _, key = _rstless_scan(frames[0])
    plan = _cached_plan(cs0.geometry, cs0.scans[0].info, key)
    return plan, [_rstless_scan(f)[1] for f in frames]


def meet_bits(plan, words, nbits, rows, cb_bits: int, limit: int):
    """Each lane's first row-relative bit at which it stands at a block
    start (bit, slot) that another variant of its row also reaches,
    walking at most ``limit`` bits from its row's first bit (``limit``
    where it meets none)."""
    bpm = plan.blocks_per_mcu
    k, w64 = st._consts(plan, CPU), st._words64(words)
    lane = torch.arange(rows.R * bpm)
    row = lane // bpm
    fr = rows.frame[row]
    nb = nbits.to(torch.int64)[fr]
    start = rows.local[row] * cb_bits
    bitpos, slot = start.clone(), lane % bpm
    coeff, blk = torch.zeros_like(bitpos), torch.zeros_like(bitpos)
    alive = torch.ones_like(bitpos, dtype=torch.bool)
    seen = []  # (lane, bit, slot) of every block start
    while True:
        alive = alive & (bitpos - start < limit)
        if not bool(alive.any()):
            break
        at = alive & (coeff == 0)
        seen.append(torch.stack([lane[at], bitpos[at], slot[at]], 1))
        s = st._symbol(plan, k, w64, fr, bitpos, slot, coeff, nb)
        alive = alive & ~s["dies"]
        bitpos, slot, coeff, blk = st._advance(plan, s, alive, bitpos, slot,
                                               coeff, blk)
    rec = torch.cat(seen).numpy()
    keys = np.stack([rec[:, 0] // bpm, rec[:, 1], rec[:, 2]], 1)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    shared = counts[inv.reshape(-1)] > 1  # a lane reaches a state once
    met = np.full(rows.R * bpm, limit, np.int64)
    rel = rec[:, 1] - start.numpy()[rec[:, 0]]
    np.minimum.at(met, rec[shared, 0], rel[shared])
    return met


def walked_bits(links, start, stop_miss):
    """Bits from ``start`` to each walk's end: its link or end bit, or for
    a miss ``stop_miss``."""
    lk = links.to(torch.int64)
    end = torch.where(lk[:, st.L_ST] == st.ST_MISS, stop_miss, lk[:, st.L_BIT])
    return int((end - start).clamp(min=0).sum())


def main() -> None:
    sizes = [int(a) for a in sys.argv[1:4]] or [
        speculative.CHUNK_BYTES, speculative.STRIP_BYTES,
        speculative.PIECE_BYTES]
    speculative.check_capacity(*sizes)
    cb, sb, pb = (8 * x for x in sizes)
    plan, segs = bench_frames()
    bpm = plan.blocks_per_mcu
    for f, seg in enumerate(segs):
        words, nbits, rows = speculative.prepare_batch([seg], CPU, sizes[0])
        met = meet_bits(plan, words, nbits, rows, cb, THRESHOLDS[-1])
        head = st.sync_head_ref(plan, words, nbits, rows, cb, sb, pb)
        lane = torch.arange(rows.R * bpm)
        row = lane // bpm
        start = rows.local[row] * cb
        stop_miss = start + cb + sb
        every, _ = st.tail_walk_ref(plan, words, nbits, rows, head.member,
                                    row, start, lane % bpm, cb, sb, pb)
        g = head.group.to(torch.int64)
        sv = g[:, st.G_SRV] == lane % bpm
        surv, _ = st.tail_walk_ref(
            plan, words, nbits, rows, head.member, row[sv], g[sv, st.G_BIT],
            g[sv, st.G_SLOT], cb, sb, pb, start_blk=g[sv, st.G_ORD],
            start_j=(torch.div(g[sv, st.G_BIT] - start[sv], pb,
                               rounding_mode="floor") + 1).clamp(
                max=st.n_pieces(cb, pb)))
        print(json.dumps({
            "frame": f, "ecs_bytes": int(seg.size), "rows": rows.R,
            "lanes": rows.R * bpm, "chunk_strip_piece_bytes": sizes,
            "met_share": {str(t): float((met < t).mean())
                          for t in THRESHOLDS},
            "median_meet_bit": float(np.median(met)),
            "survivors": int(sv.sum()),
            "tail_bits_every_variant": walked_bits(every, start, stop_miss),
            "tail_bits_survivors": walked_bits(surv, g[sv, st.G_BIT],
                                               stop_miss[sv]),
        }), flush=True)


if __name__ == "__main__":
    main()
