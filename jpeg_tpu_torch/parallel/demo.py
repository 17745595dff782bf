"""Multi-process Motion-JPEG decode demo, and the launcher of local ranks.

    python -m jpeg_tpu_torch.parallel.demo N FRAMES [--device cpu|cuda]
        [--backend gloo|nccl] [--timeout SECONDS]
    torchrun --nproc-per-node N -m jpeg_tpu_torch.parallel.demo N FRAMES

The port of ``tools/multihost_demo.py``: N ranks (processes), each with
``distributed.initialize``, its ``shard_frames`` slice of N x FRAMES
small frames, its decode (``decode_jpeg(exact=False)`` on its device),
``global_frame_batch`` of its pixels and an all-reduced checksum.  Each
rank prints one line; the launcher prints ``parallel demo: OK`` and exits
0 iff every rank did.  Under torchrun (``RANK`` and ``WORLD_SIZE`` set)
each process is one rank; else the command spawns N local ranks itself,
each with the wall limit ``--timeout``, and stops them all when one
fails.  The backend is NCCL for ``cuda`` (one card a rank) and gloo for
``cpu`` unless ``--backend`` names one.

``spawn`` runs any ``module:function`` as N such ranks, and
``check_rank`` runs the sharded paths of ``parallel.sharding`` that a
JSON spec names, on a rank, saving what each gives: the tests and
``chip_smoke.py`` drive their ranks through these two.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .distributed import initialize

PACKAGE_ROOT = Path(__file__).resolve().parents[2]
DEMO_SIZE = (120, 160)  # height, width of the demo's frames
DEFAULT_TIMEOUT_S = 600.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(world: int, target: str, payload: str, device: str = "cpu",
          backend: Optional[str] = None,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> List[str]:
    """Run ``target`` ("module:function", called as ``function(payload,
    device)``) in ``world`` local ranks of one process group; -> each
    rank's output (stdout and stderr).  Raises ``RuntimeError`` when a
    rank fails (the others are stopped at once, not left waiting in a
    collective) or the wall limit ``timeout_s`` passes."""
    port = free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(PACKAGE_ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p])}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    procs = []
    for r in range(world):
        cmd = [sys.executable, "-m", "jpeg_tpu_torch.parallel.demo",
               "--worker", target, "--payload", payload, "--rank", str(r),
               "--world", str(world), "--port", str(port), "--device",
               device, "--timeout", str(timeout_s)]
        if backend:
            cmd += ["--backend", backend]
        procs.append(subprocess.Popen(cmd, env=env, cwd=str(PACKAGE_ROOT),
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    failed = None
    while any(p.poll() is None for p in procs):
        bad = [p for p in procs if p.poll() not in (None, 0)]
        if bad or time.monotonic() > deadline:
            failed = "a rank failed" if bad else \
                f"the ranks ran past {timeout_s} s"
            break
        time.sleep(0.05)
    if failed is None and any(p.returncode for p in procs):
        failed = "a rank failed"
    if failed:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = [p.communicate()[0].decode(errors="replace") for p in procs]
    if failed:
        rcs = [p.returncode for p in procs]
        raise RuntimeError(f"{target} x{world}: {failed} (exit codes {rcs})"
                           + "".join(f"\n--- rank {i} ---\n{o[-4000:]}"
                                     for i, o in enumerate(outs)))
    return outs


def _run_worker(a) -> int:
    initialize(f"localhost:{a.port}", a.world, a.rank, device=a.device,
               backend=a.backend, timeout_s=min(a.timeout, 300.0))
    module, fn = a.worker.split(":")
    try:
        getattr(importlib.import_module(module), fn)(a.payload,
                                                     torch.device(a.device))
    finally:
        dist.destroy_process_group()
    return 0


# ---- the demo ---------------------------------------------------------


def demo_rank(payload: str, device: torch.device) -> None:
    """One rank of the demo: ``payload`` is the frames a rank."""
    from .. import decode_jpeg, encode_jpeg
    from ..encoder import EncodeParams
    from ..utils.synth import small_ppm
    from .distributed import global_frame_batch, shard_frames

    rank, n = dist.get_rank(), dist.get_world_size()
    h, w = DEMO_SIZE
    params = EncodeParams(h=2, v=2, quality=80, optimize=False,
                          restart_interval=2, exact=False)
    total = int(payload) * n
    frames = [encode_jpeg(small_ppm(w, h, seed=s), params, "cpu")
              for s in range(total)]
    mine = shard_frames(frames, rank, n)
    t0 = time.perf_counter()
    decoded = [decode_jpeg(f, device, exact=False).pixels() for f in mine]
    dt = time.perf_counter() - t0
    ok = all(d.shape == (h, w, 3) for d in decoded)
    px = torch.from_numpy(np.stack(decoded).astype(np.uint8)).to(device)
    gb = global_frame_batch(px)
    local = px.to(torch.float64).sum()
    gsum = local.clone()
    dist.all_reduce(gsum)
    ok = ok and float(local) > 0 and float(gsum) >= float(local)
    print(f"[rank {rank}/{n}] decoded {len(mine)} frames in {dt:.2f}s "
          f"({len(mine) * h * w / dt / 1e6:.1f} Mpix/s) on {device} ok={ok} "
          f"global_batch={tuple(gb.shape)} gsum={float(gsum):.0f}",
          flush=True)
    if not ok:
        raise SystemExit(1)


# ---- sharded paths on a rank (tests, chip_smoke.py) --------------------


def batch_inputs(cfg, b: int, seed: int = 0):
    """Seeded coefficient planes and tables of a ``BatchConfig`` batch:
    (y, cb, cr, qt_luma, qt_chroma), numpy int32."""
    rng = np.random.default_rng(seed)
    y = rng.integers(-64, 64, size=(b, cfg.n_luma_blocks, 64)).astype(
        np.int32)
    cb = rng.integers(-32, 32, size=(b, cfg.n_chroma_blocks, 64)).astype(
        np.int32)
    cr = rng.integers(-32, 32, size=(b, cfg.n_chroma_blocks, 64)).astype(
        np.int32)
    return (y, cb, cr, np.full(64, 8, dtype=np.int32),
            np.full(64, 16, dtype=np.int32))


def frames_file(path, frames) -> None:
    """Write JPEG frames to ``path`` (``read_frames`` reads them)."""
    np.savez(path, data=np.frombuffer(b"".join(frames), np.uint8),
             lens=np.array([len(f) for f in frames], np.int64))


def read_frames(path) -> List[bytes]:
    z = np.load(path)
    data, ends = z["data"].tobytes(), np.cumsum(z["lens"])
    return [data[e - n:e] for e, n in zip(ends, z["lens"])]


def _mesh(spec, device: torch.device, cache: dict):
    from torch.distributed.device_mesh import DeviceMesh

    from .sharding import make_mesh

    key = tuple(spec) if isinstance(spec, list) else spec
    if key not in cache:
        if key == "frame":  # a 1-D mesh of every rank
            cache[key] = DeviceMesh(device.type,
                                    torch.arange(dist.get_world_size()),
                                    mesh_dim_names=("frame",))
        elif key == "default":
            cache[key] = make_mesh(device=device.type)
        else:
            cache[key] = make_mesh(key[0] * key[1], key[1], device.type)
    return cache[key]


def _path_outputs(p: dict, mesh, device: torch.device, base: Path) -> dict:
    """Run one sharded path of a ``check_rank`` spec -> named outputs."""
    from ..encoder import EncodeParams
    from ..models.batch import BatchConfig
    from ..models.device_decode import DeviceDecoder
    from ..models.device_encode import DeviceEncoder
    from . import sharding as sh
    from .distributed import global_frame_batch

    kind = p["kind"]
    if kind == "mesh":
        return {}
    if kind in ("batch_decode", "roundtrip"):
        cfg = BatchConfig(*p["cfg"])
        y, cb, cr, ql, qc = batch_inputs(cfg, p["batch"], p["seed"])
        ys, cbs, crs = sh.shard_batch(mesh, y, cb, cr)
        ql, qc = sh.replicate(mesh, ql, qc)
        if kind == "batch_decode":
            fn = sh.make_sharded_decoder(cfg, mesh, exact=p.get("exact",
                                                                False))
            return {"px": sh.gather_full(fn(ys, cbs, crs, ql, qc))}
        out = sh.make_sharded_roundtrip(cfg, mesh)(ys, cbs, crs, ql, qc)
        return dict(zip(("y2", "cb2", "cr2", "hist"),
                        (sh.gather_full(t) for t in out)))
    if kind == "stream_decode":
        frames = read_frames(base / p["frames"])
        dec = DeviceDecoder.for_stream(frames[0], device)
        words, nbits, qt = dec.prepare(frames)
        fn = sh.make_sharded_stream_decoder(dec, mesh, len(frames),
                                            place_ri=p["place_ri"])
        px, counts = fn(words, nbits, qt)
        return {"px": sh.gather_full(px), "counts": sh.gather_full(counts),
                "n_mcus": torch.tensor(dec.plan.n_mcus)}
    if kind == "stream_encode":
        pix = np.load(base / p["pixels"])
        f, hh, ww, c = pix.shape
        enc = DeviceEncoder.for_config(hh, ww, c, EncodeParams(**p["params"]),
                                       device=device)
        fn = sh.make_sharded_stream_encoder(enc, mesh, f, p["with_hist"])
        res = fn(torch.from_numpy(pix).to(device))
        words, seg_bits, n_words, missing = res[:4]
        nw = int(n_words.to_local()[0])
        if int(missing.to_local()[0]):
            raise RuntimeError("a symbol has no code")
        local = enc._finalize_flat(
            words[:nw].cpu().numpy().view(np.uint32),
            seg_bits.to_local().cpu().numpy(),
            f // mesh.size(mesh.mesh_dim_names.index("frame")))
        out = {"jpegs": torch.from_numpy(np.frombuffer(b"".join(local),
                                                       np.uint8).copy()),
               "lens": torch.tensor([len(j) for j in local]),
               "seg_bits": sh.gather_full(seg_bits)}
        if p["with_hist"]:
            out["hist"] = sh.gather_full(res[4])
        return out
    if kind == "frame_decode":
        sh._cached_frame_decoder.cache_clear()
        outs = {}
        for i, frame in enumerate(read_frames(base / p["frames"])):
            _, planes = sh.decode_frame_sharded(frame, mesh)
            for cid, a in planes.items():
                outs[f"f{i}_c{cid}"] = torch.from_numpy(a)
        info = sh._cached_frame_decoder.cache_info()
        outs["cache_hits"] = torch.tensor(info.hits)
        outs["cache_misses"] = torch.tensor(info.misses)
        return outs
    if kind == "global_batch":
        frames = read_frames(base / p["frames"])
        from .distributed import shard_frames

        mine = shard_frames(frames, dist.get_rank(), dist.get_world_size())
        dec = DeviceDecoder.for_stream(mine[0], device)
        px = dec.decode_batch(mine)
        gb = global_frame_batch(px)
        return {"shape": torch.tensor(tuple(gb.shape)),
                "full": sh.gather_full(gb)}
    raise ValueError(f"unknown path kind {kind!r}")


def kernel_wrappers() -> dict:
    """The wrappers of the kernels the sharded paths launch, by name;
    each counts its launches in ``.launches``."""
    from ..entropy.encode_cuda import block_histogram, encode_scan
    from ..entropy.place_cuda import decode_segments, decode_segments_general
    from ..models.decode_dense import coeffs_to_pixels
    from ..models.dense_exact import color_exact, fdct_exact, idct_exact
    from ..models.dense_fast import decode_frame_fast, encode_frame_fast
    from ..models.encode_dense import pixels_to_zz
    from ..models.flat_rows import rows_from_flat

    return {f.__name__: f for f in (
        decode_segments, decode_segments_general, coeffs_to_pixels,
        pixels_to_zz, encode_scan, block_histogram, idct_exact, fdct_exact,
        color_exact, decode_frame_fast, encode_frame_fast, rows_from_flat)}


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()


def check_rank(payload: str, device: torch.device) -> None:
    """Run the sharded paths of the JSON spec at ``payload`` on this rank.

    The spec: ``{"paths": [{"name", "kind", "mesh": [frame, tile],
    "frame" or "default", ...}], "digest": bool, "repeat": int}``; file
    names in it are relative to the spec's directory.  Kinds:
    ``batch_decode`` / ``roundtrip`` (``cfg``, ``batch``, ``seed``,
    ``exact``: seeded ``batch_inputs``), ``stream_decode`` (``frames``,
    ``place_ri``), ``stream_encode`` (``pixels`` .npy, ``params``,
    ``with_hist``), ``frame_decode`` (``frames``: each through
    ``decode_frame_sharded``, the decoder cache cleared first),
    ``global_batch`` (``frames``) and ``mesh`` (the mesh alone;
    ``"default"`` is ``make_mesh()``).  Each path runs ``repeat`` times
    (default 1) and its last run's outputs, gathered whole on every rank,
    go to ``<name>.r<rank>.npz`` beside the spec: arrays or, with
    ``digest``, their sha256; with ``seconds`` of each run (host clock,
    synchronized), the last run's kernel launches (``launches``, JSON:
    the counts of ``kernel_wrappers``; none on the CPU, where the plain
    versions run) and, on a card, its ``peak_MiB``.
    """
    base = Path(payload).parent
    spec = json.loads(Path(payload).read_text())
    rank = dist.get_rank()
    meshes: dict = {}
    wrappers = kernel_wrappers()
    for p in spec["paths"]:
        mesh = _mesh(p["mesh"], device, meshes)
        seconds = []
        for _ in range(spec.get("repeat", 1)):  # the last run is kept
            before = {k: f.launches for k, f in wrappers.items()}
            if device.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            t0 = time.perf_counter()
            outs = _path_outputs(p, mesh, device, base)
            if device.type == "cuda":
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        launches = {k: f.launches - before[k] for k, f in wrappers.items()
                    if f.launches > before[k]}
        save = {"seconds": np.array(seconds),
                "launches": np.array(json.dumps(launches)),
                "mesh_shape": np.array(mesh.shape),
                "mesh_names": np.array(mesh.mesh_dim_names)}
        if device.type == "cuda":
            save["peak_MiB"] = np.float64(torch.cuda.max_memory_allocated()
                                          / 2**20)
        for k, t in outs.items():
            save[k] = np.array(_digest(t)) if spec.get("digest") \
                else t.detach().cpu().numpy()
        np.savez(base / f"{p['name']}.r{rank}.npz", **save)


# ---- command line -----------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m jpeg_tpu_torch.parallel.demo")
    ap.add_argument("n", type=int, nargs="?", default=2)
    ap.add_argument("frames", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--payload", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker:
        return _run_worker(a)
    if os.environ.get("RANK") and os.environ.get("WORLD_SIZE"):
        initialize(device=a.device, backend=a.backend,
                   timeout_s=min(a.timeout, 300.0))
        try:
            demo_rank(str(a.frames), torch.device(a.device))
        finally:
            dist.destroy_process_group()
        return 0
    try:
        outs = spawn(a.n, "jpeg_tpu_torch.parallel.demo:demo_rank",
                     str(a.frames), a.device, a.backend, a.timeout)
    except RuntimeError as e:
        print(e, flush=True)
        print("parallel demo: FAILED", flush=True)
        return 1
    for o in outs:
        print(o, end="", flush=True)
    print("parallel demo: OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
