"""Step bounds of the lockstep scan, copied from jpeg_tpu.

``_max_steps_for`` and ``_grow_steps`` are jpeg_tpu's
(``jpeg_tpu/entropy/lockstep_jax.py:740-765``), line for line: pure
NumPy, but their module imports JAX, so the port keeps this copy.  The
port's kernels decode every lane to its end and need no step bound; the
bounds feed ``DeviceDecoder``'s learned phase schedule (``max_steps``,
``_phases_for``), which keeps jpeg_tpu's so that the two decoders learn
the same lane order from the same batches.
"""

from __future__ import annotations

import numpy as np

from .lockstep import ScanPlan


def _max_steps_for(
    nbits: np.ndarray, plan: ScanPlan, ri: int, optimistic: bool = True
) -> int:
    max_nbits = int(nbits.max()) if nbits.size else 0
    blocks = (ri if ri else max(plan.n_mcus, 1)) * plan.blocks_per_mcu
    # Hard bound: one symbol consumes >= 1 bit; <= 65 symbols per block
    # (+ slack for trailing-padding garbage the reference also decodes);
    # +2 for the death step and the delayed pending-DC flush.
    bound = min(max_nbits + 2, 65 * (blocks + 2) + 2)
    if optimistic:
        # Long segments are dense content with many extra bits per symbol,
        # so bits/symbol GROWS with segment length -- real lanes average
        # well over 3 bits/symbol, plus ~1 symbol (EOB) per block floor.
        # Aggressive by design: a starved decode retries one 128-step
        # bucket up (``_grow_steps``) and DeviceDecoder remembers the
        # learned bound across batches of a stream.
        est = blocks + max_nbits // 6 + 16
        steps = max(128, min(bound, est))
        return max(128, steps // 128 * 128)
    steps = max(64, bound)
    return 1 << (steps - 1).bit_length()


def _grow_steps(max_steps: int, hard_cap: int) -> int:
    """Next starvation-retry bound: +50%, 128-step buckets, capped."""
    return min(hard_cap, (max_steps * 3 // 2 + 127) // 128 * 128)
