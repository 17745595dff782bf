"""The benchmark's inputs, made from ``--seed`` by its own code.

A configuration's corpus is ``contents`` distinct frames: the pattern of
the repository's original benchmark (smooth gradients plus seeded noise,
``content``), each encoded in float64 by the baseline encoder of the configuration's
plain reference (``references/<reference>.py``).  The frames' contents differ by the
phases of their gradients and by their noise; every seed gives frames of
the same size and statistics, so every seed gives the same work.

Inputs are made in a child process (``python3 -m perfbench.corpus``,
which reads its order as JSON on standard input) and written inside the
checkout, under ``perfbench/.cache/corpus/<config>/<kind>-<seed>-<contents>-<hash>.npz``;
the run reads them back from there, whether they were made for it or
for an earlier run of the seed.  So the process that runs the window has
done the same work before it, either way: making the corpus allocates
and frees large host arrays, which leaves the host allocator in another
state than reading it does, and the window's host speed with it.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "perfbench" / ".cache" / "corpus"


def content(seed: int, index: int, width: int, height: int) -> np.ndarray:
    """[height, width, 3] uint8 RGB: three smooth gradients with phases
    drawn from (``seed``, ``index``), plus Gaussian noise of 2% of full
    scale."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), int(index)])
    ph = rng.uniform(0.0, 2 * np.pi, 3).astype(np.float32)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    img = np.stack([
        0.5 + 0.5 * np.sin(xx / 37.0 + ph[0]) * np.cos(yy / 23.0 + ph[1]),
        (xx + yy) / (width + height),
        0.5 + 0.5 * np.cos(xx / 61.0 - yy / 41.0 + ph[2]),
    ], axis=-1)
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(np.round(img * 255), 0, 255).astype(np.uint8)


def reference(config: dict):
    """The configuration's plain reference module (``reference``)."""
    from .cell import HERE, load_module

    return load_module(HERE / "references" / f"{config['reference']}.py")


def _planes(config: dict, seed: int, index: int) -> List[np.ndarray]:
    """The quantized blocks of one content, float64 on the host."""
    import torch

    ref = reference(config)
    geom = ref.geometry_of(config)
    rgb = torch.from_numpy(content(seed, index, geom.width, geom.height))
    return [p[0].numpy().astype(np.int16) for p in
            ref.forward(rgb[None], int(config["quality"]), geom,
                        dtype=torch.float64)]


def _frame(config: dict, seed: int, index: int) -> bytes:
    ref = reference(config)
    return ref.encode_frame(_planes(config, seed, index),
                            ref.geometry_of(config), int(config["quality"]),
                            int(config["restart_interval"]))


def _key(config: dict) -> str:
    """A short hash of the configuration's encoding parameters."""
    keys = ("width", "height", "sampling", "quality", "restart_interval")
    blob = json.dumps({k: config[k] for k in keys}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def _path(kind: str, config: dict, seed: int, contents: int) -> Path:
    return (CACHE / config["name"]
            / f"{kind}-{int(seed)}-{contents}-{_key(config)}.npz")


def _make(kind: str, config: dict, seed: int, contents: int,
          path: Path) -> None:
    """Write the ``kind`` inputs' file at ``path`` (run in the child)."""
    if kind == "frames":
        out = [_frame(config, seed, i) for i in range(contents)]
        arrays = {"blob": np.frombuffer(b"".join(out), np.uint8),
                  "ends": np.cumsum([len(f) for f in out])}
    elif kind == "pixels":
        arrays = {"pixels": np.stack([
            content(seed, i, int(config["width"]), int(config["height"]))
            for i in range(contents)])}
    else:
        raise ValueError(f"no inputs of kind {kind!r}")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _inputs(kind: str, config: dict, seed: int, contents: int):
    """-> (the file's arrays, seconds taken, whether a child made them)."""
    t0 = time.perf_counter()
    path = _path(kind, config, seed, contents)
    made = not path.exists()
    if made:
        order = json.dumps({"kind": kind, "config": config,
                            "seed": int(seed), "contents": int(contents),
                            "path": str(path)})
        p = subprocess.run([sys.executable, "-m", "perfbench.corpus"],
                           input=order, cwd=ROOT, capture_output=True,
                           text=True)
        if p.returncode != 0 or not path.exists():
            raise RuntimeError(f"making the corpus failed ({p.returncode}): "
                               f"{p.stderr[-2000:]}")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, time.perf_counter() - t0, made


def frames(config: dict, seed: int,
           contents: int) -> Tuple[List[bytes], float, bool]:
    """-> (the ``contents`` encoded frames, seconds taken, whether they
    were made for this call)."""
    z, seconds, made = _inputs("frames", config, seed, contents)
    blob, ends = z["blob"].tobytes(), z["ends"].tolist()
    starts = [0] + ends[:-1]
    return [blob[s:e] for s, e in zip(starts, ends)], seconds, made


def planes(config: dict, seed: int, index: int) -> List[np.ndarray]:
    """The quantized blocks corpus frame ``index`` encodes, worked out
    again from the seed (for the decode cells' reference)."""
    return _planes(config, seed, index)


def pixels(config: dict, seed: int,
           contents: int) -> Tuple[np.ndarray, float, bool]:
    """-> ([contents, H, W, 3] uint8, the frames as pixels (the encode
    cells' input), seconds taken, whether they were made for this
    call)."""
    z, seconds, made = _inputs("pixels", config, seed, contents)
    return z["pixels"], seconds, made


def clip_orders(seed: int, contents: int, frames: int,
                clips: int) -> List[np.ndarray]:
    """``clips`` orders of ``frames`` contents each, drawn from ``seed``:
    every content the same number of times (to within one), shuffled."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 1])
    return [rng.permutation(np.resize(np.arange(contents), frames))
            for _ in range(clips)]


def main() -> int:
    order = json.loads(sys.stdin.read())
    _make(order["kind"], order["config"], order["seed"], order["contents"],
          Path(order["path"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
