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
                       MCU rows, the last one is short: the general-shape
                       decode takes it)
  short_422_ri5.mjpeg  2 frames, 48x32 4:2:2, ri=5 (12 MCUs: 5, 5, 2)
  short_p12_420_ri5.mjpeg
                       1 frame, 64x48 12-bit 4:2:0, ri=5 (5, 5, 2),
                       optimized tables
  row_420_ri3.mjpeg    2 frames, 64x48 4:2:0, ri=3 (divides the 12 MCUs,
                       not the 4-MCU row)
  short_gray_ri4.mjpeg 2 frames, 40x40 grayscale, ri=4 (25 MCUs, last
                       segment 1)
  rstless_420.mjpeg    2 frames, 48x32 4:2:0, no restart markers (one
                       lane per frame)
  multiscan_ri4.mjpeg, multiscan_ri0.mjpeg
                       1 frame each, 48x32 4:2:0 as three Ns=1 scans (one
                       per component), with DRI 4 (6 MCUs per scan: 4, 2)
                       and without restart markers
  mixed_420_ri2.mjpeg  3 frames, 64x48 4:2:0, ri=2; frame 1 carries
                       optimized tables, so the stream's plan rejects it
  digests.json         per stream, one sha256 per frame of the frame's
                       jpeg_tpu.decode_coefficients planes, concatenated
                       in geometry order as int32 [total_blocks, 64]
  exact.json           "pnm": per stream, one sha256 per frame of
                       jpeg_tpu.decode_jpeg(frame, exact=True).to_pnm()
                       (bench: frame 0 only); "encode": sha256 and size
                       of jpeg_tpu.encode_jpeg(bench.make_frame_ppm(0))
                       with exact=True, per named parameter set

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
    "short_422_ri5": dict(size=(48, 32), h=2, v=1, ri=5, frames=2),
    "short_p12_420_ri5": dict(size=(64, 48), h=2, v=2, ri=5, frames=1,
                              maxval=4095, optimize=True),
    "row_420_ri3": dict(size=(64, 48), h=2, v=2, ri=3, frames=2),
    "short_gray_ri4": dict(size=(40, 40), h=1, v=1, ri=4, frames=2,
                           gray=True),
    "rstless_420": dict(size=(48, 32), h=2, v=2, ri=0, frames=2),
}
MULTISCAN_RI = (4, 0)
# Exact encodes of bench.make_frame_ppm(0) whose bytes chip_smoke.py
# checks: name -> EncodeParams fields.
EXACT_ENCODES = {
    "bench0_420_q75_opt": dict(h=2, v=2, quality=75, optimize=True,
                               restart_interval=0),
    "bench0_422_q90_ri7": dict(h=2, v=1, quality=90, optimize=False,
                               restart_interval=7),
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


def pnm_digest(frame: bytes) -> str:
    """sha256 of jpeg_tpu's exact decode, written as PNM."""
    import jpeg_tpu

    return hashlib.sha256(
        jpeg_tpu.decode_jpeg(frame, exact=True).to_pnm()).hexdigest()


def multiscan_frame(ri: int) -> bytes:
    """A 48x32 4:2:0 frame coded as three Ns=1 scans, one per component
    (decoder.c:274-302), with restart interval ``ri`` (0: none)."""
    import numpy as np

    from jpeg_tpu.constants import (
        DEFAULT_HTABLES,
        STD_CHROMINANCE_QUANT,
        STD_LUMINANCE_QUANT,
        scale_qtable,
    )
    from jpeg_tpu.encoder import EncodeParams, geometry_for_image
    from jpeg_tpu.entropy.encode import pack_scan, symbolize_scan
    from jpeg_tpu.format import emit
    from jpeg_tpu.geometry import ScanInfo
    from jpeg_tpu.models.pipeline import encode_frame
    from jpeg_tpu.tables import HuffSpec, derive_table
    from jpeg_tpu.utils.pnm import read_pnm
    from refbin import make_ppm

    src = make_ppm(48, 32, seed=60 + ri)
    geom = geometry_for_image(read_pnm(src), EncodeParams(h=2, v=2))
    img = read_pnm(src, pad_to=(16, 16))
    qt = np.ones((4, 64), dtype=np.uint16)
    qt[0] = scale_qtable(STD_LUMINANCE_QUANT, 80)
    qt[1] = scale_qtable(STD_CHROMINANCE_QUANT, 80)
    planes = {cid: np.asarray(p) for cid, p in encode_frame(
        img.data, geom, qt.astype(np.int32), exact=False).items()}
    specs = {k: HuffSpec.from_pair(v) for k, v in DEFAULT_HTABLES.items()}
    tables = {k: derive_table(v) for k, v in specs.items()}
    out = bytearray(emit.emit_soi())
    out += emit.emit_dqt(qt[0], 0) + emit.emit_dqt(qt[1], 1)
    out += emit.emit_sof0(geom)
    for key in ((0, 0), (1, 0), (0, 1), (1, 1)):
        out += emit.emit_dht(specs[key], *key)
    if ri:
        out += emit.emit_dri(ri)
    for comp in geom.components:
        info = ScanInfo(component_ids=(comp.cid,), td=(comp.td,),
                        ta=(comp.ta,))
        out += emit.emit_sos(info)
        out += emit.emit_scan_body(
            pack_scan(symbolize_scan(planes, geom, info, ri), tables, ri))
    out += emit.emit_eoi()
    return bytes(out)


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
    for ri in MULTISCAN_RI:
        streams[f"multiscan_ri{ri}"] = [multiscan_frame(ri)]
    mixed = [EncodeParams(h=2, v=2, quality=80, optimize=opt,
                          restart_interval=2, exact=False)
             for opt in (False, True, False)]
    streams["mixed_420_ri2"] = [encode_jpeg(make_ppm(64, 48, seed=70 + i), p)
                                for i, p in enumerate(mixed)]
    digests = {}
    exact = {"pnm": {}, "encode": {}}
    for name, frames in streams.items():
        (OUT / f"{name}.mjpeg").write_bytes(b"".join(frames))
        digests[name] = [coeff_digest(f) for f in frames]
        exact["pnm"][name] = [pnm_digest(f)
                              for f in frames[:1 if name == "bench" else None]]
    (OUT / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")
    ppm = bench.make_frame_ppm(0)
    for name, fields in EXACT_ENCODES.items():
        data = encode_jpeg(ppm, EncodeParams(exact=True, **fields))
        exact["encode"][name] = dict(
            params=fields, bytes=len(data),
            sha256=hashlib.sha256(data).hexdigest())
    (OUT / "exact.json").write_text(json.dumps(exact, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"wrote {len(streams)} streams to {OUT} ({total} bytes)")


if __name__ == "__main__":
    main()
