"""Device lockstep entropy decode of one scan: the single-image API's
``entropy="lockstep-jax"`` backend (the port of
``jpeg_tpu/entropy/lockstep_jax.py::decode_scan_lockstep_jax``).

The JAX backend decodes a scan on its device as ``decode_scan_device``:
the lockstep symbol scan over every restart segment (``_scan_lanes``),
then the prefix-sum scatter (``_place_emissions``), for every scan shape.
Here the scan's segments are packed into lane words
(``lockstep_torch.pack_words``) and decoded by one call of the general
segment decode, ``place_cuda.decode_segments_general``, with the scan as
one frame of ``len(segments)`` lanes: on a CUDA device its kernels (the
count walk with the layout, place, resolve), on the CPU its plain version
(the eager scan and ``place_emissions``).  The one-pass region kernel is
never taken: on a damaged stream it places a lane's blocks at fixed
offsets, where the prefix sum moves them as the JAX backend does.

A scan the kernels' tables do not hold (``place_cuda.check_plan``: more
than 16 blocks per MCU, 8 Huffman tables or 4 components) decodes with
the serial oracle, the JAX backend's own rule for more than 16 blocks per
MCU, and is counted in ``lockstep_jax.serial_scans``.  Nothing else falls
back: a kernel that does not build or launch raises.

Step bound.  The JAX scan runs to a static step bound and retries a
starved scan up to a hard cap (``_max_steps_for``), which with ``ri=0``,
what its API passes, is at least ``min(max bits + 2, 65 * (blocks + 2) +
2)`` steps for the scan's ``blocks``.  The kernels and the plain scan run
every lane to its end.  An interleaved lane dies at its first MCU past
the frame, so the two can differ only on a non-interleaved scan whose
segment runs on for more than that many symbols: its MCU count stops at
the cap there and not here.

Sanitizer.  With ``JPEG_TPU_CHECKS=2`` (a test tier, as in the JAX
package) the plain scan and placement run again on the same tensors after
the decode, with the JAX tier's checks (``scan_lanes(checks=True)``: no
live lane decodes an invalid symbol while 16 bits of its segment remain;
``place_emissions(checks=True)``: no valid emission lands out of bounds),
and raise ``CorruptStream("sanitizer: ...")``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..errors import UnsupportedError
from ..utils.metrics import default_metrics
from .lockstep_torch import _cached_plan, pack_words
from .place_cuda import (
    check_plan,
    decode_segments_general,
    decode_segments_general_ref,
)


def decode_scan_lockstep_jax(geom, info, tables, spec_items: tuple,
                             segments: Sequence[np.ndarray],
                             planes: Dict[int, np.ndarray],
                             device: torch.device) -> int:
    """Decode one scan on ``device`` into ``planes`` (host int32 [n_blocks,
    64] per component id) and return its MCU count, the sum of the lanes'
    counts.  ``tables`` are the scan's derived Huffman tables (for the
    serial oracle), ``spec_items`` their sorted ``(key, HuffSpec)`` pairs
    (the plan's cache key)."""
    plan = _cached_plan(geom, info, spec_items)
    try:
        check_plan(plan)
    except UnsupportedError:
        from .serial import decode_scan_serial

        default_metrics.count("lockstep_jax.serial_scans")
        return decode_scan_serial(geom, info, tables, list(segments), planes)
    comps = [geom.by_id(cid) for cid in info.component_ids]
    total_blocks = sum(c.n_blocks for c in comps)
    lens = np.array([s.size for s in segments], dtype=np.int64)
    words, nbits = pack_words(
        np.concatenate(segments) if lens.sum() else np.zeros(0, np.uint8),
        lens)
    w = torch.from_numpy(words.view(np.int32)).to(device)
    nb = torch.from_numpy(nbits.astype(np.int32)).to(device)
    args = (plan, w, nb, 1, len(segments), total_blocks)
    coeffs, counts = decode_segments_general(*args)

    from ..api import checks_level

    if checks_level() >= 2:
        decode_segments_general_ref(*args, checks=True)
    c = coeffs.cpu().numpy()  # the scan's one copy of its coefficients
    off = 0
    for comp in comps:
        planes[comp.cid][:] = c[off : off + comp.n_blocks]
        off += comp.n_blocks
    return int(counts.sum())
