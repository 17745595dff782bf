"""Multi-device sharding on ``torch.distributed``: mesh construction and
sharded batched pipelines.  The port of ``jpeg_tpu/parallel/sharding.py``.

The scaling design is the JAX package's: a 2-D ``('frame', 'tile')``
mesh -- frames of a Motion-JPEG batch shard over 'frame' (pure data
parallel, zero communication), the block axis within each frame over
'tile' (JPEG blocks do not overlap, so there are no halos).  The mesh is
a ``DeviceMesh`` of one rank a device, and PyTorch's ``DTensor`` plays
the part of ``NamedSharding``: inputs and outputs carry the placements of
the JAX ``in_specs`` / ``out_specs``.

What XLA inserted into the JAX programs is explicit here.  Each rank runs
the port's kernels on its local tensors (``DTensor.to_local``), the
collectives between them are ``torch.distributed`` calls on the mesh's
groups -- all_gather over 'tile' before a frame's dense decode, an
all-reduce (SUM) of histograms, the all_gather of lane MCU counts and
the all-reduce of the frame buffer in the context-parallel frame decode
-- and results are wrapped back with ``DTensor.from_local``.  Only
``all_gather`` and ``all_reduce`` are used: both NCCL and gloo take them
for CUDA tensors (DTensor's own functional collectives are not used, as
gloo does not take them for CUDA tensors).  ``gather_full`` assembles a
sharded result on every rank.

Arguments that a JAX program needed for its static shapes have no
counterpart: the port's segment kernels decode every lane to its end, so
there is no ``max_steps`` and nothing starves.  Where the JAX programs
return a ``starved`` flag, the port returns the lanes' MCU counts, which
the caller checks against the frame's MCUs as ``DeviceDecoder._run``
does.

Expert (MoE) and pipeline parallelism have no analog in a codec, as in
the JAX package.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (
    DTensor,
    Replicate,
    Shard,
    distribute_tensor,
)

from ..entropy.lockstep import ScanPlan
from ..models.batch import (
    BatchConfig,
    decode_batch_ycc,
    dc_histogram,
    encode_batch_ycc,
)


def make_mesh(n_devices: Optional[int] = None, tile: Optional[int] = None,
              device="cuda") -> DeviceMesh:
    """('frame', 'tile') mesh over the ranks of the process group.

    ``tile`` defaults to 2 when the rank count is even (so both axes are
    exercised), else 1.  ``device`` gives the mesh's device type
    (``"cuda"`` unless the caller asks for ``"cpu"``).  The group must be
    up (``distributed.initialize``) and ``n_devices``, where given, its
    size: every rank of the group is one device of the mesh.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "jpeg_tpu_torch.parallel.distributed.initialize")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} ranks, the "
                         f"group has {world}")
    if tile is None:
        tile = 2 if n % 2 == 0 and n >= 2 else 1
    if n % tile:
        raise ValueError(f"tile ({tile}) must divide the device count ({n})")
    grid = torch.arange(n).reshape(n // tile, tile)
    return DeviceMesh(torch.device(device).type, grid,
                      mesh_dim_names=("frame", "tile"))


def local_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _placements(mesh: DeviceMesh, shards: dict) -> list:
    """Per mesh dim: ``Shard(shards[name])`` where the dim is named in
    ``shards``, else ``Replicate()``."""
    return [Shard(shards[name]) if name in shards else Replicate()
            for name in mesh.mesh_dim_names]


def _tensor(a, mesh: DeviceMesh) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a)) \
        if isinstance(a, np.ndarray) else a
    return t.to(local_device(mesh))


def _distribute(mesh: DeviceMesh, arrays, placements) -> tuple:
    out = []
    for a in arrays:
        t = _tensor(a, mesh)
        # src_data_rank=None: every rank holds the whole array (as the JAX
        # host array) and keeps its own shard; no collective runs.
        out.append(distribute_tensor(t, mesh, placements,
                                     src_data_rank=None))
    return tuple(out) if len(out) > 1 else out[0]


def shard_batch(mesh: DeviceMesh, *arrays):
    """Place ``[B, n_blocks, ...]`` arrays as ('frame', 'tile', None...):
    ``DTensor`` ``[Shard(0), Shard(1)]``."""
    return _distribute(mesh, arrays, [Shard(0), Shard(1)])


def replicate(mesh: DeviceMesh, *arrays):
    """Place arrays whole on every device: ``[Replicate()] * ndim``."""
    return _distribute(mesh, arrays, [Replicate()] * mesh.ndim)


def _local(x, mesh: DeviceMesh, placements) -> torch.Tensor:
    """This rank's shard of ``x`` under ``placements``: a ``DTensor``
    with those placements gives its local tensor, any other array is the
    whole array and gives this rank's slice of it (no collective)."""
    if isinstance(x, DTensor):
        if list(x.placements) != list(placements):
            raise ValueError(f"input placed {x.placements}, want "
                             f"{placements}")
        return x.to_local()
    return distribute_tensor(_tensor(x, mesh), mesh, placements,
                             src_data_rank=None).to_local()


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors of ``t``'s shape, concatenated along ``dim`` in
    group-rank order (one ``all_gather``)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def gather_full(x) -> torch.Tensor:
    """The whole tensor of a ``DTensor`` (Shard/Replicate placements,
    even shards) on every rank, gathered with ``all_gather`` over each
    sharded mesh dim; a plain tensor comes back as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    t = x.to_local()
    for i in reversed(range(mesh.ndim)):
        p = x.placements[i]
        if isinstance(p, Shard):
            t = all_gather_cat(t, mesh.get_group(i), p.dim)
    return t


def _frame_index(mesh: DeviceMesh, axis: str = "frame"):
    """(this rank's index along ``axis``, the axis size, its group)."""
    return (mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(
        axis)), mesh.get_group(axis))


def _gather_tiles(mesh: DeviceMesh, *planes) -> list:
    """Local [B_f, n / tile, 64] blocks -> [B_f, n, 64]: the all_gather
    over 'tile' that XLA inserts before the blocks -> raster transpose."""
    group = mesh.get_group("tile")
    return [all_gather_cat(p, group, dim=1) for p in planes]


def make_sharded_decoder(cfg: BatchConfig, mesh: DeviceMesh,
                         exact: bool = False):
    """Batched decode with mesh-sharded inputs and outputs.

    -> ``decode(y, cb, cr, qt_luma, qt_chroma)``: coefficient planes
    placed ('frame', 'tile', None) (``shard_batch``; whole arrays are
    sliced), tables replicated.  Each rank all-gathers its frames' tile
    shards over 'tile', runs ``decode_batch_ycc`` (K11 a frame, or K4
    with ``exact``) and returns float32 RGB ``[B, H, W, 3]`` placed
    ('frame', None, None, None): ``Shard(0)`` over 'frame'.
    """
    sharded = _placements(mesh, {"frame": 0, "tile": 1})
    rep = [Replicate()] * mesh.ndim
    out = _placements(mesh, {"frame": 0})

    def decode(y, cb, cr, qt_luma, qt_chroma):
        planes = _gather_tiles(mesh, *(_local(p, mesh, sharded)
                                       for p in (y, cb, cr)))
        px = decode_batch_ycc(cfg, *planes, _local(qt_luma, mesh, rep),
                              _local(qt_chroma, mesh, rep), exact=exact)
        return DTensor.from_local(px, mesh, out, run_check=False)

    return decode


def make_sharded_stream_decoder(dec, mesh: DeviceMesh, frames: int,
                                place_ri: int = 0):
    """Full stream decode (segment kernel + dense tail) sharded over
    'frame'.

    Frames are embarrassingly parallel, so the whole words -> pixels
    pipeline runs on each rank with zero collectives: each rank decodes
    its own frames' restart segments (lanes are grouped frame-major) with
    ``dec.decode_prepared`` and the dense tail K3.  ``dec`` is a built
    ``DeviceDecoder`` (it holds the plan and geometry the JAX function
    takes); ``frames`` must be a multiple of the mesh's 'frame' axis.
    ``place_ri > 0`` takes the one-pass region kernel (K1, the port of
    the Pallas lane-region placement; the shape must be eligible), 0 the
    general kernel (K2, the scatter placement).

    -> ``decode(words [F*spf, Wn], nbits [F*spf], qtables [F, 4, 64]) ->
    (pixels [F, H, W, C], mcu_counts [F*spf])``, both ``Shard(0)`` over
    'frame' (whole arrays are sliced; ``DeviceDecoder.prepare``'s output
    fits).  ``mcu_counts`` takes the place of JAX's ``starved``: a frame
    decoded whole has ``dec.plan.n_mcus`` MCUs.
    """
    from ..models.decode_dense import coeffs_to_pixels

    _, n, _ = _frame_index(mesh)
    if frames % n:
        raise ValueError(
            f"frames ({frames}) must divide over 'frame' ({n}); for a "
            "single frame use make_sharded_frame_decoder (segments shard "
            "across devices instead)")
    fpd = frames // n
    spf = dec.segs_per_frame
    part = _placements(mesh, {"frame": 0})

    def decode(words, nbits, qtables):
        w = _local(words, mesh, part)
        nb = _local(nbits, mesh, part)
        qt = _local(qtables, mesh, part)
        if w.shape[0] != fpd * spf:
            raise ValueError(f"words hold {w.shape[0]} lanes a rank, want "
                             f"{fpd} frames x {spf}")
        coeffs, counts = dec.decode_prepared(w, nb, fpd, place_ri=place_ri)
        px = coeffs_to_pixels(coeffs, qt, dec.geom)
        return (DTensor.from_local(px, mesh, part, run_check=False),
                DTensor.from_local(counts, mesh, part, run_check=False))

    return decode


def make_sharded_frame_decoder(plan: ScanPlan, mesh: DeviceMesh,
                               n_segments: int, total_blocks: int,
                               axis: str = "frame"):
    """ONE frame's restart segments shard across devices (true context
    parallelism).

    Each rank decodes its contiguous slice of the frame's segment lanes
    with the general kernel (K2).  The global placement offsets are the
    exclusive prefix sum of the per-lane MCU counts across ranks: one
    ``all_gather`` of the counts over ``axis`` between the kernel's count
    walk and its place walk gives each rank the MCUs of the earlier
    ranks' lanes, added to its lanes' first MCUs on the device
    (``decode_segments_general``'s ``lane_base``).  Each rank places its
    coefficients into a frame-sized zero buffer, and one ``all_reduce``
    (SUM) over ``axis`` combines them: write-disjoint on an intact frame;
    on a damaged one, writes of two ranks into one coefficient add, as
    the JAX ``psum`` adds them.  (DC needs no cross-rank chain: restart
    markers reset predictors per segment.)

    The lane count must divide the axis; callers pad with empty lanes
    (nbits 0 decodes zero MCUs).  ``max_steps`` has no counterpart (no
    step bound).  -> ``decode(words [S, Wn], nbits [S]) -> (coeffs
    [total_blocks, 64] replicated, mcu_counts [S] Shard(0) over
    axis)``.
    """
    from ..entropy.place_cuda import decode_segments_general

    idx, n, group = _frame_index(mesh, axis)
    if n_segments % n:
        raise ValueError(
            f"segment lanes ({n_segments}) must divide over '{axis}' ({n}); "
            "pad with empty (nbits=0) lanes")
    sl = n_segments // n
    part = _placements(mesh, {axis: 0})
    rep = [Replicate()] * mesh.ndim

    def lane_base(counts: torch.Tensor) -> torch.Tensor:
        every = all_gather_cat(counts, group)  # [n * sl], rank order
        return every[: idx * sl].sum().to(torch.int32)

    def decode(words, nbits):
        w = _local(words, mesh, part)
        nb = _local(nbits, mesh, part)
        coeffs, counts = decode_segments_general(
            plan, w, nb, 1, sl, total_blocks, lane_base=lane_base)
        dist.all_reduce(coeffs, op=dist.ReduceOp.SUM, group=group)
        return (DTensor.from_local(coeffs, mesh, rep, run_check=False),
                DTensor.from_local(counts, mesh, part, run_check=False))

    return decode


@lru_cache(maxsize=64)
def _cached_frame_decoder(plan, mesh, n_segments, total_blocks, axis):
    """One decoder per (plan, mesh, shape), so frames 2..N of a stream
    reuse frame 1's (its kernel tables stay cached with the plan)."""
    return make_sharded_frame_decoder(plan, mesh, n_segments, total_blocks,
                                      axis=axis)


def decode_frame_sharded(data: bytes, mesh: DeviceMesh, axis: str = "frame"):
    """Decode ONE JPEG's entropy across every device on ``axis``.

    The host parses and unstuffs, pads the lane set to the axis size, runs
    the context-parallel decode on the mesh's devices, and returns
    ``(codestream, planes)``: host int32 ``[n_blocks, 64]`` coefficient
    planes by component id, the same on every rank.  The frame needs
    restart markers (the parallel axis); an RST-less frame is one lane.
    """
    from ..entropy.lockstep_torch import _cached_plan, pack_words
    from ..errors import UnsupportedError
    from ..format.parse import parse_codestream, unstuff

    cs = parse_codestream(data)
    geom = cs.geometry
    if geom is None or len(cs.scans) != 1:
        raise UnsupportedError("sharded frame decode wants one frame/scan")
    scan = cs.scans[0]
    plan = _cached_plan(geom, scan.info, tuple(sorted(scan.htables.items())))
    segments = [unstuff(data[s:e]) for s, e in scan.ecs_ranges]
    _, n, _ = _frame_index(mesh, axis)
    while len(segments) % n:
        segments.append(np.zeros(0, np.uint8))  # empty lane: zero MCUs
    lens = np.array([s.size for s in segments], dtype=np.int64)
    words, nbits = pack_words(
        np.concatenate(segments) if lens.sum() else np.zeros(0, np.uint8),
        lens)
    total_blocks = sum(
        geom.by_id(cid).n_blocks for cid in scan.info.component_ids)
    decode = _cached_frame_decoder(plan, mesh, len(segments), total_blocks,
                                   axis)
    dev = local_device(mesh)
    coeffs, _ = decode(torch.from_numpy(words.view(np.int32)).to(dev),
                       torch.from_numpy(nbits.astype(np.int32)).to(dev))
    coeffs = coeffs.to_local().cpu().numpy()
    planes = {}
    off = 0
    for cid in scan.info.component_ids:
        nb = geom.by_id(cid).n_blocks
        planes[cid] = coeffs[off : off + nb]
        off += nb
    return cs, planes


def make_sharded_stream_encoder(enc, mesh: DeviceMesh, frames: int,
                                with_hist: bool = False):
    """Full stream encode (dense + entropy) sharded over 'frame'.

    The mirror of ``make_sharded_stream_decoder``: each rank encodes its
    own frames with zero collectives (``enc.dense``, K5; ``enc.scan``,
    K6) -- except with ``with_hist``, where each rank's symbol histogram
    (``enc.histogram``, K7) is all-reduced (SUM) over 'frame', the JAX
    ``psum``.  ``enc`` is a built ``DeviceEncoder``; ``frames`` must be a
    multiple of the mesh's 'frame' axis.

    -> ``encode(pixels [F, H, W, C], ehufco=None, ehufsi=None) -> (words,
    seg_bits, n_words, missing[, hist])``: ``words`` is the rank's own
    word stream (``enc.scan``'s, the stream being ``words[:n_words]``:
    its length depends on the data, so it stays a local tensor);
    ``seg_bits`` ``[F * n_segments]``, ``n_words`` and ``missing`` (one a
    rank) ``Shard(0)`` over 'frame'; ``hist`` ``[T, 256]`` replicated.
    ``n_words`` stands where JAX returns ``overflow``: the port writes at
    exact offsets and has no capacity to overflow.  Default code tables
    are the encoder's.
    """
    _, n, group = _frame_index(mesh)
    if frames % n:
        raise ValueError(f"frames ({frames}) must divide over 'frame' ({n})")
    part = _placements(mesh, {"frame": 0})
    rep = [Replicate()] * mesh.ndim

    def encode(pixels, ehufco=None, ehufsi=None):
        px = enc._pixels(_local(pixels, mesh, part))
        zz = enc.dense(px)
        hist = None
        if with_hist:
            hist = enc.histogram(zz)
            dist.all_reduce(hist, op=dist.ReduceOp.SUM, group=group)
        words, _, seg_bits, missing, n_words = enc.scan(zz, ehufco, ehufsi)

        def shard(t):
            return DTensor.from_local(t.reshape(-1), mesh, part,
                                      run_check=False)

        out = [words, shard(seg_bits), shard(n_words), shard(missing)]
        if with_hist:
            out.append(DTensor.from_local(hist, mesh, rep, run_check=False))
        return tuple(out)

    return encode


def make_sharded_roundtrip(cfg: BatchConfig, mesh: DeviceMesh):
    """Full-pipeline step (decode + re-encode + histogram all-reduce).

    -> ``step(y, cb, cr, qt_luma, qt_chroma) -> (y2, cb2, cr2, hist)``:
    each rank gathers its frames' tile shards, decodes (K11) and
    re-encodes (K12) them, keeps its own tile shard of the new planes
    (placed as the inputs, ('frame', 'tile', None)), and counts the DC
    categories of its shard of ``y2``; the ``[16]`` histogram is
    all-reduced (SUM) over the whole mesh and replicated.
    """
    sharded = _placements(mesh, {"frame": 0, "tile": 1})
    rep = [Replicate()] * mesh.ndim
    ti = mesh.get_local_rank("tile")
    tiles = mesh.size(mesh.mesh_dim_names.index("tile"))

    def step(y, cb, cr, qt_luma, qt_chroma):
        planes = _gather_tiles(mesh, *(_local(p, mesh, sharded)
                                       for p in (y, cb, cr)))
        ql, qc = _local(qt_luma, mesh, rep), _local(qt_chroma, mesh, rep)
        rgb = decode_batch_ycc(cfg, *planes, ql, qc)
        new = [p.chunk(tiles, dim=1)[ti].contiguous()
               for p in encode_batch_ycc(cfg, rgb, ql, qc)]
        hist = dc_histogram(new[0])
        for i in range(mesh.ndim):
            dist.all_reduce(hist, op=dist.ReduceOp.SUM,
                            group=mesh.get_group(i))
        return (*(DTensor.from_local(p, mesh, sharded, run_check=False)
                  for p in new),
                DTensor.from_local(hist, mesh, rep, run_check=False))

    return step

