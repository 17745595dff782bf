"""Multi-process orchestration for Motion-JPEG workloads on
``torch.distributed``: the port of ``jpeg_tpu/parallel/distributed.py``.

* ``initialize()`` starts the process group from explicit arguments or
  torchrun's environment (``MASTER_ADDR`` / ``MASTER_PORT`` /
  ``WORLD_SIZE`` / ``RANK``) -- one process a rank;
* frames are the data-parallel unit: ``shard_frames`` assigns each rank
  a contiguous slice of a frame list (the host-side input pipeline), and
  ``global_frame_batch`` wraps the rank's decoded batch as one logical
  ``[F, H, W, C]`` ``DTensor`` sharded over all ranks, so downstream
  consumers see one batch.

Per-frame decode is embarrassingly parallel; collectives only appear
inside a frame (the tile gather, histogram all-reduces, the context-
parallel frame decode: ``sharding``).  The backend follows the caller's
device, never a probe: NCCL for ``cuda`` (one card a rank: NCCL refuses
two ranks on one card), gloo for ``cpu``; ``backend=`` overrides it
(gloo also moves CUDA tensors, e.g. for ranks that share one card).
Without a process group every entry point keeps working for a single
process.
"""

from __future__ import annotations

import datetime
import os
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# How long a collective may wait for a rank that died before it fails.
DEFAULT_TIMEOUT_S = 120.0


def backend_for(device) -> str:
    """The process group backend of ``device``: NCCL for CUDA, gloo else."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Tuple[int, int]:
    """Initialize the default process group -> (rank, world size).

    Resolution order: explicit arguments (``coordinator_address``
    "host:port"), then torchrun's ``MASTER_ADDR``:``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK``, then a single process without a group,
    ``(0, 1)``.  A group of one process is started too when it is asked
    for, so that a mesh can be built over it.  The backend is
    ``backend_for(device)`` unless ``backend`` names one; with a CUDA
    device each rank takes card ``LOCAL_RANK`` (else its rank) modulo the
    card count.  A group that is already up is returned as it is.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    addr = coordinator_address
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    n = num_processes or int(os.environ.get("WORLD_SIZE", "0") or 0)
    pid = (process_id if process_id is not None
           else int(os.environ.get("RANK", "-1") or -1))
    if not (addr and n >= 1 and 0 <= pid < n):
        return 0, 1
    dev = torch.device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", pid))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend or backend_for(dev), init_method=f"tcp://{addr}",
        world_size=n, rank=pid,
        timeout=datetime.timedelta(seconds=timeout_s))
    return pid, n


def shard_frames(
    frames: Sequence[bytes], process_id: int, num_processes: int
) -> List[bytes]:
    """This process's contiguous slice of the global frame list."""
    per = -(-len(frames) // num_processes)
    return list(frames[process_id * per : (process_id + 1) * per])


@lru_cache(maxsize=8)
def _process_mesh(device_type: str, mesh_axis: str):
    """A 1-D mesh of every rank, one a process (built once a process)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(mesh_axis,))


def global_frame_batch(local_batch, mesh_axis: str = "frame"):
    """Assemble a process-spanning batch from per-rank batches.

    ``local_batch`` is this rank's ``[F_local, H, W, C]`` batch (numpy or
    a tensor, e.g. a ``DeviceDecoder`` output).  The result is a
    ``DTensor`` of shape ``[F_local * world, H, W, C]``, ``Shard(0)``
    over a 1-D ``(mesh_axis,)`` mesh of all ranks, on the batch's own
    device; every rank's batch must have the same shape.  Nothing moves:
    each rank keeps its frames.  A single process (no group, or a group
    of one) gets ``local_batch`` back unchanged.
    """
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return local_batch
    from torch.distributed.tensor import DTensor, Shard

    t = torch.as_tensor(np.asarray(local_batch)) \
        if isinstance(local_batch, np.ndarray) else local_batch
    mesh = _process_mesh(t.device.type, mesh_axis)
    return DTensor.from_local(t.contiguous(), mesh, [Shard(0)],
                              run_check=False)
