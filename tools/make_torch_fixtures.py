"""Write the PyTorch port's committed test corpus (tests/data/torch_port/).

The port's chip check and CPU tests need JPEG streams, and the machine
with the GPU has neither JAX nor an encoder in the port, so the corpus is
encoded here once with the JAX package (on the CPU) and committed:

  bench.mjpeg          2 frames, 1920x1080 4:2:0 q75, restart interval 4
                       (bench.py's stream shape: 2,040 segments per frame)
  yuv420_ri2.mjpeg     3 frames, 64x48 4:2:0, ri=2
  yuv444_ri3.mjpeg     2 frames, 48x48 4:4:4, ri=3 (odd region width)
  gray_ri4.mjpeg       2 frames, 48x48 grayscale (Ns=1 scan), ri=4
  p12_422_ri2.mjpeg    1 frame, 64x32 12-bit 4:2:2, ri=2, optimized tables
  ineligible_420_ri3.mjpeg
                       1 frame, 64x32 4:2:0, ri=3 (segments do not tile
                       MCU rows: the segment kernel must refuse it)
  digests.json         per stream, one sha256 per frame of the frame's
                       jpeg_tpu.decode_coefficients planes, concatenated
                       in geometry order as int32 [total_blocks, 64]

Run from the repository root:  JAX_PLATFORMS=cpu python tools/make_torch_fixtures.py
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "data" / "torch_port"

# name -> frame size, sampling, restart interval, frame count, options
SMALL = {
    "yuv420_ri2": dict(size=(64, 48), h=2, v=2, ri=2, frames=3),
    "yuv444_ri3": dict(size=(48, 48), h=1, v=1, ri=3, frames=2),
    "gray_ri4": dict(size=(48, 48), h=1, v=1, ri=4, frames=2, gray=True),
    "p12_422_ri2": dict(size=(64, 32), h=2, v=1, ri=2, frames=1,
                        maxval=4095, optimize=True),
    "ineligible_420_ri3": dict(size=(64, 32), h=2, v=2, ri=3, frames=1),
}


def coeff_digest(frame: bytes) -> str:
    """sha256 of jpeg_tpu's coefficient planes, geometry order, int32."""
    import numpy as np

    import jpeg_tpu

    cs, planes = jpeg_tpu.decode_coefficients(frame)
    cat = np.concatenate(
        [np.asarray(planes[c.cid], np.int32).reshape(-1, 64)
         for c in cs.geometry.components]
    )
    return hashlib.sha256(np.ascontiguousarray(cat).tobytes()).hexdigest()


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import jax

    jax.config.update("jax_platforms", "cpu")
    import bench
    from jpeg_tpu.encoder import EncodeParams, encode_jpeg
    from refbin import make_pgm, make_ppm

    OUT.mkdir(parents=True, exist_ok=True)
    streams = {}
    p_bench = EncodeParams(h=2, v=2, quality=75, optimize=False,
                           restart_interval=bench.RESTART_INTERVAL,
                           exact=False)
    streams["bench"] = [encode_jpeg(bench.make_frame_ppm(s), p_bench)
                        for s in range(2)]
    for name, cfg in SMALL.items():
        params = EncodeParams(h=cfg["h"], v=cfg["v"], quality=80,
                              optimize=cfg.get("optimize", False),
                              restart_interval=cfg["ri"], exact=False)
        make = make_pgm if cfg.get("gray") else make_ppm
        w, h = cfg["size"]
        streams[name] = [
            encode_jpeg(make(w, h, seed=11 * i + cfg["ri"],
                             maxval=cfg.get("maxval", 255)), params)
            for i in range(cfg["frames"])
        ]
    digests = {}
    for name, frames in streams.items():
        (OUT / f"{name}.mjpeg").write_bytes(b"".join(frames))
        digests[name] = [coeff_digest(f) for f in frames]
    (OUT / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"wrote {len(streams)} streams to {OUT} ({total} bytes)")


if __name__ == "__main__":
    main()
