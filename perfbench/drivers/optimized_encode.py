"""Driver: frames that live on the card, each encoded to a JPEG file with
the optimal Huffman tables of its own symbols, as ``cjpeg -optimize``
writes one.

``make_inputs`` fails at once, before the corpus is made, where the
program's ``DeviceEncoder`` offers no such mode (its ``OPTIMIZE_MODES``
lack the traffic's ``optimize``): a program that would code the clips
with other tables runs no window of them.  Otherwise ``batch_encode``'s
driver, whose set-up and clips it takes: each call is
``encoder.encode_batch(clip, optimize=<the traffic's>, chunk)`` ->
``List[bytes]``, closed loop, one caller.

The check (``judge_frames``) decodes each sampled frame with the tables
its own DHT carries (``jpeg_optimized.decode_segments``), once for each
distinct frame and content, and holds it to the plain reference's
float32 quantized blocks of its content:

- ``frames_malformed``: frames missing from a call, or whose markers,
  tables or segment count depart from the configuration, or that do not
  decode;
- ``table_off_share``: frames whose four tables are not the Annex K.2
  tables of the symbols the frame codes (the reference's K.2 of the
  counts its decode read);
- ``seg_diff_share``: restart segments whose decoded coefficients differ
  from the reference's;
- ``coef_max_gap``: the largest difference of a coefficient, over every
  segment of every judged frame.

A frame's tables follow its coefficients, and the program's float32 path
differs from the reference's on rounding boundaries, so the tables of a
frame may differ from those of the reference's encode of its content,
and every byte after them; the coefficients do not.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench import corpus
from perfbench.cell import load_module

_batch = load_module(Path(__file__).with_name("batch_encode.py"))
KIND = _batch.KIND


def make_inputs(cell, seed: int):
    from jpeg_tpu_torch import DeviceEncoder

    mode = cell.traffic["optimize"]
    if mode not in getattr(DeviceEncoder, "OPTIMIZE_MODES", ()):
        raise RuntimeError(f"the program's DeviceEncoder has no "
                           f"optimize={mode!r} mode")
    return _batch.make_inputs(cell, seed)


def _judge_frame(ref, frame: bytes, want: np.ndarray, geom, quality: int,
                 ri: int):
    """-> None for a malformed frame, else (its tables are the K.2 tables
    of its symbols, segments whose coefficients differ, the largest
    coefficient difference)."""
    markers, segs, problem = ref.split_frame(frame)
    if problem or len(segs) != geom.segments(ri):
        return None
    bad, tables = ref.header_problems(markers, geom, quality, ri)
    if bad:
        return None
    try:
        got, hist = ref.decode_segments(segs, geom, ri, tables)
    except ValueError:
        return None
    try:
        own = ref.optimal_tables(hist) == tables
    except ValueError:
        own = False
    gap = np.abs(got - want)
    per = (ri or geom.n_mcus) * geom.bpm
    differ = np.unique(np.flatnonzero(gap.any(axis=1)) // per).size
    return own, differ, int(gap.max())


def judge_frames(ref, samples: Sequence[Tuple[object, Sequence[int]]],
                 want: Sequence[np.ndarray], config: dict) -> Dict[str,
                                                                   float]:
    """``samples``: (a call's output, a list of JPEG frames, the contents
    of its frames); ``want``: each content's reference blocks
    (``jpeg_optimized.scan_blocks``)."""
    geom = ref.geometry_of(config)
    quality, ri = int(config["quality"]), int(config["restart_interval"])
    malformed, frames, off, differ, gap = 0, 0, 0, 0, 0
    seen: dict = {}
    for out, contents in samples:
        if not isinstance(out, list) or len(out) != len(contents):
            malformed += len(contents)
            continue
        for frame, c in zip(out, contents):
            if not isinstance(frame, (bytes, bytearray)):
                malformed += 1
                continue
            key = (bytes(frame), c)
            if key not in seen:
                seen[key] = _judge_frame(ref, key[0], want[c], geom,
                                         quality, ri)
            got = seen[key]
            if got is None:
                malformed += 1
                continue
            frames += 1
            off += not got[0]
            differ += got[1]
            gap = max(gap, got[2])
    total = frames * geom.segments(ri)
    return {"frames_malformed": malformed,
            "table_off_share": off / frames if frames else 1.0,
            "seg_diff_share": differ / total if total else 1.0,
            "coef_max_gap": gap}


class Driver(_batch.Driver):
    def call(self, i: int, optimize=None):
        """``encode_batch`` of clip ``i`` in the traffic's mode (the base's
        ``optimize`` flag is not read), or in ``optimize``."""
        mode = self.cell.traffic["optimize"] if optimize is None else optimize
        return self.enc.encode_batch(self.clips[i % len(self.clips)],
                                     optimize=mode, chunk=self.chunk)

    def _planes(self, tf32: bool = False) -> List[List[np.ndarray]]:
        """Each content's quantized blocks by the reference, float32 on
        the run's device (TF32 products where asked)."""
        ref, cfg = self.cell.reference, self.cell.config
        geom = ref.geometry_of(cfg)
        out = []
        for c in range(self.cell.traffic["contents"]):
            rgb = torch.from_numpy(corpus.content(
                self.seed, c, geom.width, geom.height)).to(self.device)
            out.append([p[0].cpu().numpy() for p in ref.forward(
                rgb[None], int(cfg["quality"]), geom, dtype=torch.float32,
                tf32=tf32)])
        return out

    def judge(self, samples) -> dict:
        ref = self.cell.reference
        if self._want is None:
            geom = ref.geometry_of(self.cell.config)
            self._want = [ref.scan_blocks(p, geom) for p in self._planes()]
        return judge_frames(
            ref, [(out, self.contents(i)) for i, out in samples],
            self._want, self.cell.config)

    def _encode(self, planes) -> bytes:
        ref, cfg = self.cell.reference, self.cell.config
        return ref.encode_frame(planes, ref.geometry_of(cfg),
                                int(cfg["quality"]),
                                int(cfg["restart_interval"]))

    def control(self, calls):
        """The reference with TF32 products, in the program's place."""
        low = [self._encode(p) for p in self._planes(tf32=True)]
        return [(i, [low[c] for c in self.contents(i)]) for i in calls]

    def controls(self, calls) -> Dict[str, list]:
        """The outputs that must each read ``correct`` false, by name: the
        TF32 reference; the program with the Annex K tables and with
        per-batch tables; and the program's output with its first frame
        replaced by the reference's encode of that content with one
        coefficient's sign flipped (the same symbols, so the same optimal
        tables).  Call before ``close``."""
        out = {"tf32": self.control(calls)}
        for name, mode in (("annex_k", False), ("per_batch", True)):
            out[name] = [(i, self.call(i, mode)) for i in calls]
        rng = np.random.default_rng([int(self.seed) & (2 ** 64 - 1), 3])
        want = self._planes()
        altered = []
        for i in calls:
            planes = [p.copy() for p in want[self.contents(i)[0]]]
            y = planes[0].reshape(-1, 64)
            rows, cols = np.nonzero(y[:, 1:])
            j = int(rng.integers(0, rows.size))
            y[rows[j], cols[j] + 1] *= -1
            altered.append((i, [self._encode(planes)] + self.call(i)[1:]))
        out["altered"] = altered
        return out
