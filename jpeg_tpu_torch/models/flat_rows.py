"""The flat prep's lane-row rebuild (K13).

``rows_from_flat`` is the port of the gather in the JAX package's
``device_decode._decode_device_flat``: the flat prep mode uploads a
chunk's restart segments packed back to back in one u32 buffer, and the
device rebuilds the ``[S, wn]`` lane matrix the segment decode reads,
``words[s, j] = buf[clip(starts[s] + j, 0, blen - 1)]`` (``jnp.take(...,
mode="clip")``).  On a CUDA tensor it launches ``csrc/flat_rows.cu`` and
counts the launch in ``rows_from_flat.launches``; on a CPU tensor it runs
the plain version ``rows_from_flat_ref``; anything else raises.  The
contract is bitwise equality between the two.
"""

from __future__ import annotations

import torch

from ..device import check_tensor, cuda_stream

I32 = (torch.int32,)


def rows_from_flat_ref(buf: torch.Tensor, starts: torch.Tensor,
                       wn: int) -> torch.Tensor:
    """[blen] int32 words and [S] int32 word offsets -> [S, wn] int32:
    row s is ``buf[starts[s]:starts[s] + wn]``, indices clipped to the
    buffer."""
    idx = starts.to(torch.int64)[:, None] + torch.arange(
        wn, dtype=torch.int64, device=buf.device)[None, :]
    return buf[idx.clamp(0, buf.numel() - 1)]


def rows_from_flat(buf: torch.Tensor, starts: torch.Tensor,
                   wn: int) -> torch.Tensor:
    """The lane matrix [S, wn] int32 of a flat buffer, on ``buf``'s
    device.  The kernel takes ``wn`` a multiple of 4 (its 16-byte row
    stores) and a non-empty buffer."""
    if buf.device.type == "cpu":
        return rows_from_flat_ref(buf, starts, wn)
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"rows_from_flat: unsupported device {dev}")
    blen, S = int(buf.numel()), int(starts.numel())
    check_tensor("buf", buf, I32, (blen,), dev)
    check_tensor("starts", starts, I32, (S,), dev)
    if wn <= 0 or wn % 4 or blen == 0:
        raise ValueError(f"rows_from_flat: wn must be a positive multiple "
                         f"of 4 and the buffer non-empty, got wn={wn}, "
                         f"blen={blen}")

    from ..kernels import load_library

    words = torch.empty(S, wn, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = load_library().lib.jt_rows_from_flat(
            buf.data_ptr(), starts.data_ptr(), words.data_ptr(), blen, S, wn,
            cuda_stream(dev))
    if rc != 0:
        raise RuntimeError(f"rows_from_flat launch failed: CUDA error {rc}")
    rows_from_flat.launches += 1
    return words


rows_from_flat.launches = 0
