"""Command-line tools mirroring the reference binaries (the port of
``jpeg_tpu/cli.py``: its subcommands, getopt letters, defaults, outputs
and exit codes).

``python -m jpeg_tpu_torch.cli decode [input.jpg [output.ppm|pgm]]``
  mirrors decoder main() (decoder.c:703-718): defaults in="Lenna.jpg",
  output path defaults to output.ppm/output.pgm by component count.

``python -m jpeg_tpu_torch.cli encode [-h N] [-v N] [-q Q] [-o 0|1]
                                 [-r Ri] [input.ppm|pgm [output.jpg]]``
  mirrors encoder main() (encoder.c:669-724) with the same getopt
  letters (-h/-v are the LUMA SAMPLING FACTORS, not help -- use
  --help) and defaults (h=2, v=1, q=75, optimize=1), plus extensions:
  -r restart interval, --fast, --entropy-backend (``jax``: the segment
  encode on the device).

``python -m jpeg_tpu_torch.cli mjpeg input.mjpeg outdir [--chunk N]
                                [--isolate]``
  decodes a raw Motion-JPEG stream into numbered PPM/PGM frames.

Every subcommand takes ``--device`` (default ``cuda``).  Without a card
the CLI names ``--device cpu`` and fails: it never moves to the CPU on
its own.

Exit status: 0 on success, 1 on failure, like the reference.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _decode(args) -> int:
    from . import decode_jpeg
    from .errors import JpegError

    try:
        data = Path(args.input).read_bytes()
    except OSError:
        print("fopen failure", file=sys.stderr)
        return 1
    try:
        img = decode_jpeg(data, args.device, exact=not args.fast,
                          entropy=args.entropy)
    except JpegError as e:
        print(f"Failure. ({type(e).__name__}: {e})", file=sys.stderr)
        return 1
    if args.verbose:
        _print_decode_diagnostics(img)
    out = args.output
    if out is None:
        out = "output.ppm" if img.geometry.nf >= 3 else "output.pgm"
    Path(out).write_bytes(img.to_pnm())
    print("Success.")
    return 0


def _print_decode_diagnostics(img) -> None:
    """The reference's stdout narration under -v: qtable dumps
    (decoder.c:60-65), COM text (decoder.c:403-431), expected-vs-
    processed macroblock counts (common.c:174, decoder.c:385), and the
    trailing-garbage report (decoder.c:604-609)."""
    from .api import expected_mcus

    cs, geom = img.codestream, img.geometry
    used = sorted({c.tq for c in geom.components})
    for tq in used:
        print(f"quantization table {tq}:")
        qt = cs.qtables[tq].reshape(8, 8)
        for row in qt:
            print("  " + " ".join(f"{v:3d}" for v in row))
    for com in cs.comments:
        try:
            text = com.decode("ascii")
        except UnicodeDecodeError:
            text = com.decode("latin-1")
        print(f"comment: {text}")
    for i, scan in enumerate(cs.scans):
        want = expected_mcus(geom, scan.info)
        got = cs.mcus_decoded[i] if i < len(cs.mcus_decoded) else 0
        print(f"scan {i}: {got} macroblocks processed, {want} expected")
    if cs.trailing_garbage:
        print(f"{cs.trailing_garbage} bytes of garbage after EOI")


def _mjpeg(args) -> int:
    import numpy as np

    from . import mjpeg
    from .errors import JpegError
    from .utils.pnm import write_pnm

    try:
        data = Path(args.input).read_bytes()
    except OSError:
        print("fopen failure", file=sys.stderr)
        return 1
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    try:
        if args.isolate:
            res = mjpeg.decode_stream(data, args.device)
            for i, img in enumerate(res.frames):
                if img is None:
                    continue
                ext = "ppm" if img.geometry.nf >= 3 else "pgm"
                (outdir / f"frame_{i:05d}.{ext}").write_bytes(img.to_pnm())
            for i, msg in res.errors:
                print(f"frame {i}: {msg}", file=sys.stderr)
            print(f"Success. ({res.ok_count}/{len(res.frames)} frames)")
            return 0 if res.ok_count else 1
        px = mjpeg.decode_stream_device(data, args.device,
                                        chunk=args.chunk).cpu().numpy()
    except JpegError as e:
        print(f"Failure. ({type(e).__name__}: {e})", file=sys.stderr)
        return 1
    f, h, w, c = px.shape
    ext = "ppm" if c >= 3 else "pgm"
    from .format.parse import parse_codestream

    prec = parse_codestream(mjpeg.split_stream(data)[0]).geometry.precision
    for i in range(f):
        pnm = write_pnm(px[i].astype(np.float32), w, h, prec, components=c)
        (outdir / f"frame_{i:05d}.{ext}").write_bytes(pnm)
    print(f"Success. ({f} frames)")
    return 0


def _encode(args) -> int:
    from .encoder import EncodeParams, encode_jpeg
    from .errors import JpegError

    try:
        data = Path(args.input).read_bytes()
    except OSError:
        print("fopen failure", file=sys.stderr)
        return 1
    params = EncodeParams(
        h=args.H,
        v=args.V,
        quality=args.quality,
        optimize=bool(args.optimize),
        restart_interval=args.restart_interval,
        exact=not args.fast,
        entropy_backend=args.entropy_backend,
    )
    try:
        jpg = encode_jpeg(data, params, args.device)
    except JpegError as e:
        print(f"Failure. ({type(e).__name__}: {e})", file=sys.stderr)
        return 1
    Path(args.output).write_bytes(jpg)
    print("Success.")
    return 0


def main(argv=None) -> int:
    # --device on every subcommand: the port's entry points take an
    # explicit device.
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default="cuda",
                     help="torch device the decode/encode runs on "
                          "(default cuda; cpu runs the plain versions)")

    parser = argparse.ArgumentParser(prog="jpeg_tpu_torch", add_help=True)
    sub = parser.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("decode", help="JPEG -> PPM/PGM", parents=[dev])
    d.add_argument("input", nargs="?", default="Lenna.jpg")
    d.add_argument("output", nargs="?", default=None)
    d.add_argument("--fast", action="store_true", help="fast f32 path (not bit-exact)")
    d.add_argument("--entropy", default="auto",
                   choices=["auto", "serial", "lockstep", "lockstep-jax",
                            "native", "speculative"])
    d.add_argument("-v", "--verbose", action="store_true",
                   help="print qtables, comments, MCU counts, trailing "
                        "garbage (the reference's stdout narration)")
    d.set_defaults(fn=_decode)

    # add_help=False so the reference's getopt letters survive verbatim:
    # -h is the LUMA H SAMPLING FACTOR (encoder.c:677-699), not help.
    # --help still works.
    e = sub.add_parser("encode", help="PPM/PGM -> JPEG", add_help=False,
                       parents=[dev])
    e.add_argument("--help", action="help",
                   help="show this help message and exit")
    e.add_argument("-h", "-H", "--H", dest="H", type=int, default=2,
                   help="luma H sampling (1..2; reference getopt -h)")
    e.add_argument("-v", "-V", "--V", dest="V", type=int, default=1,
                   help="luma V sampling (1..2; reference getopt -v)")
    e.add_argument("-q", "--quality", type=int, default=75)
    e.add_argument("-o", "--optimize", type=int, default=1)
    e.add_argument("-r", "--restart-interval", type=int, default=0,
                   help="MCUs per restart interval (0 = none)")
    e.add_argument("--fast", action="store_true", help="fast f32 path")
    e.add_argument("--entropy-backend", default="numpy",
                   choices=["numpy", "jax", "native"],
                   help="entropy coder: numpy (host), jax (the segment "
                        "encode on --device), native (threaded C++; falls "
                        "back to numpy)")
    e.add_argument("input", nargs="?", default="Lenna.ppm")
    e.add_argument("output", nargs="?", default="output.jpg")
    e.set_defaults(fn=_encode)

    m = sub.add_parser("mjpeg", help="raw MJPEG stream -> PPM/PGM frames",
                       parents=[dev])
    m.add_argument("input")
    m.add_argument("outdir")
    m.add_argument("--chunk", type=int, default=8,
                   help="frames per device chunk")
    m.add_argument("--isolate", action="store_true",
                   help="per-frame decode with fault isolation instead "
                        "of the batched device path")
    m.set_defaults(fn=_mjpeg)

    args = parser.parse_args(argv)
    from .device import resolve

    try:
        args.device = resolve(args.device)
    except RuntimeError as err:
        print(f"Failure. ({err}; pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
