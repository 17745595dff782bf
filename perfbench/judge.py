"""The comparisons that decide ``correct``.

Each returns the numbers compared, by name.  The limits live in the
configuration's file (``limits``); ``verdict`` holds the numbers to them.

- Decoded pixels (``judge_pixels``): each frame a call returned against
  the reference's pixels of the content it encodes.  ``frames_malformed``
  counts frames of the wrong shape or type and frames missing from a
  call; ``px_off_share`` is the share of samples that differ from the
  reference's, ``px_max_gap`` the largest difference.
- Encoded frames (``judge_frames``): each frame a call returned, read
  back segment by segment against the reference's encode of the same
  pixels.  ``frames_malformed`` counts frames whose markers, tables or
  segment count depart from the configuration; ``seg_diff_share`` is the
  share of restart segments whose bytes differ; ``coef_max_gap`` the
  largest coefficient difference in a sample of those segments, decoded
  (a segment that does not decode counts as a gap of 2**15).
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

import torch

UNDECODABLE = 2 ** 15
# Differing segments decoded for ``coef_max_gap``: a sample drawn from
# the seed, since the decoder here is plain Python.
DECODE_AT_MOST = 64


def judge_pixels(samples: Sequence[Tuple[object, Sequence[int]]],
                 want: torch.Tensor) -> Dict[str, float]:
    """``samples``: (a call's output [n, H, W, 3], the contents of its n
    frames); ``want``: [contents, H, W, 3] uint8 reference pixels."""
    malformed, off, total, gap = 0, 0, 0, 0
    for out, contents in samples:
        ok = (isinstance(out, torch.Tensor) and out.dim() == 4
              and tuple(out.shape[1:]) == tuple(want.shape[1:])
              and out.dtype == torch.uint8)
        if not ok:
            malformed += len(contents)
            continue
        malformed += max(0, len(contents) - out.shape[0])
        malformed += max(0, out.shape[0] - len(contents))
        for j, c in enumerate(contents[:out.shape[0]]):
            d = (out[j].to(want.device, torch.int16)
                 - want[c].to(torch.int16)).abs()
            off += int((d > 0).sum())
            gap = max(gap, int(d.max()))
            total += d.numel()
    return {"frames_malformed": malformed,
            "px_off_share": off / total if total else 1.0,
            "px_max_gap": gap}


def judge_frames(ref, samples: Sequence[Tuple[object, Sequence[int]]],
                 want: Sequence[List[bytes]], config: dict,
                 seed: int) -> Dict[str, float]:
    """``ref``: the configuration's reference module; ``samples``: (a
    call's output, a list of JPEG frames, the contents of its frames);
    ``want``: each content's reference segments."""
    geom = ref.geometry_of(config)
    quality, ri = int(config["quality"]), int(config["restart_interval"])
    malformed, differ, total, gap = 0, [], 0, 0
    nseg = geom.segments(ri)
    for out, contents in samples:
        if not isinstance(out, list) or len(out) != len(contents):
            malformed += len(contents)
            continue
        for frame, c in zip(out, contents):
            if not isinstance(frame, (bytes, bytearray)):
                malformed += 1
                continue
            markers, segs, problem = ref.split_frame(bytes(frame))
            if problem or len(segs) != nseg or ref.header_problems(
                    markers, geom, quality, ri):
                malformed += 1
                continue
            total += nseg
            differ += [(k, a, b) for k, (a, b) in
                       enumerate(zip(segs, want[c])) if a != b]
    per = ri or geom.n_mcus
    for k, a, b in random.Random(seed).sample(
            differ, min(DECODE_AT_MOST, len(differ))):
        mcus = min(per, geom.n_mcus - k * per)
        try:
            got = ref.decode_segment(a, geom, mcus)
        except ValueError:
            gap = UNDECODABLE
            continue
        gap = max(gap, int(abs(got - ref.decode_segment(b, geom, mcus)).max()))
    return {"frames_malformed": malformed,
            "seg_diff_share": len(differ) / total if total else 1.0,
            "coef_max_gap": gap}


def verdict(numbers: Dict[str, float],
            limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """-> (every number within its limit, {name: {value, limit}})."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(v["value"] <= v["limit"] for v in table.values()), table
