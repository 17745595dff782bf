"""Time the RST-less engine's kernels over K10's piece size, on a card.

Run from the repository root on a machine with a CUDA card:

    python3 tools/rstless_piece_sweep.py [piece bytes ...]

For the 8-frame 1080p batch of chip_smoke's phase 13 (512-byte rows,
128-byte strips) and each piece size (default 16, 32, 64, 128, 256, 512:
512 is one piece a row), it prints one JSON line: the CUDA-event times of
``rstless_sync`` (K8, whose marks grow with the pieces a row),
``rstless_resolve`` (K9) and ``rstless_final`` (K10), each the mean of 10
back-to-back calls, and the device time of K10's piece walk and DC pass
from one profiled call.  Every piece size must decode the batch to the
same coefficients.  The card's name and power limit lead the output.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from jpeg_tpu_torch import kernels  # noqa: E402
from jpeg_tpu_torch.device import set_precision  # noqa: E402


def device_ms(run, kernel_names) -> dict:
    """Device milliseconds of each named kernel in one profiled ``run()``."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {k: 0.0 for k in kernel_names}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for k in kernel_names:
            if f"::{k}(" in e.name or f"::{k}<" in e.name:
                out[k] += (e.time_range.end - e.time_range.start) / 1e3
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("rstless_piece_sweep: needs a CUDA card")
    pieces = [int(a) for a in sys.argv[1:]] or [16, 32, 64, 128, 256, 512]
    card = cs.card_label()
    cs.log(card)
    set_precision()
    kernels.load_library()
    dev = torch.device("cuda")
    core, sc, _ = cs.rstless_modules()
    _, _, _, plan, tb, segs = cs.rstless_stream(dev)
    words, nbits, rows = core.prepare_batch(segs[:cs.CHUNK], dev)
    cb, sb = core.CHUNK_BYTES * 8, core.STRIP_BYTES * 8
    rounds = 1 + int(np.diff(rows.row0).max())
    first = None
    for pbytes in pieces:
        core.check_capacity(core.CHUNK_BYTES, core.STRIP_BYTES, pbytes)
        pb = pbytes * 8
        links, member, marks = sc.sync(plan, words, nbits, rows, cb, sb, pb)
        res = sc.resolve(plan, words, nbits, rows, links, member, marks, cb,
                         sb, pb, rounds)
        coeffs, ok = sc.final(plan, words, nbits, rows, res.pieces, tb)
        if first is None:
            first = coeffs
        elif not torch.equal(first, coeffs):
            raise AssertionError(f"piece {pbytes} B: coefficients differ "
                                 f"from the first run's")
        rec = {
            "piece_bytes": pbytes,
            "pieces_a_batch": int(res.pieces.shape[0]),
            "rows_not_ok": int((ok == 0).sum()),
            "rstless_sync_ms": cs.cuda_ms(
                lambda: sc.sync(plan, words, nbits, rows, cb, sb, pb), 10),
            "rstless_resolve_ms": cs.cuda_ms(
                lambda: sc.resolve(plan, words, nbits, rows, links, member,
                                   marks, cb, sb, pb, rounds), 10),
            "rstless_final_ms": cs.cuda_ms(
                lambda: sc.final(plan, words, nbits, rows, res.pieces, tb),
                10),
            "device_ms": device_ms(
                lambda: sc.final(plan, words, nbits, rows, res.pieces, tb),
                ("final_kernel", "dc_kernel")),
            "card": card,
        }
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
