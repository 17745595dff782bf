"""Host microseconds of each step of the exact FDCT's wrapper
(``models/dense_exact.fdct_exact``) on a card, one step at a time, mean
of 200 calls, on the 1080p Y plane's shape (32,640 blocks).

Run from the repository root on a machine with a CUDA card:

    python3 tools/fdct_wrapper_probe.py

The card's name and power limit lead the output, then one line a step;
the last step is the whole wrapper.  ``idct_exact`` and ``color_exact``
take the same steps.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from jpeg_tpu_torch import kernels  # noqa: E402
from jpeg_tpu_torch.device import check_tensor, cuda_stream  # noqa: E402
from jpeg_tpu_torch.models.dense_exact import fdct_exact  # noqa: E402
from jpeg_tpu_torch.ops.dct import dct_lut_f32  # noqa: E402

BLOCKS = 32640  # the 1080p Y plane
REPS = 200


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fdct_wrapper_probe: needs a CUDA card")
    card = cs.card_label()
    cs.log(card)
    rng = np.random.default_rng(0)
    blocks = torch.from_numpy(rng.integers(0, 256, (BLOCKS, 64))
                              .astype(np.float32)).to("cuda")
    dev = blocks.device  # cuda:N, as the wrapper checks it
    qtable = torch.from_numpy(rng.integers(1, 256, 64)
                              .astype(np.int32)).to(dev)
    lib = kernels.load_library().lib
    out = torch.empty(BLOCKS, 64, dtype=torch.int32, device=dev)
    stream = cuda_stream(dev)
    fdct_exact(blocks, qtable, 8)  # loads the module

    def context():
        with torch.cuda.device(dev):
            pass

    steps = {
        "check_tensor x2": lambda: (
            check_tensor("blocks", blocks, (torch.float32,), (BLOCKS, 64),
                         dev),
            check_tensor("qtable", qtable, (torch.int32,), (64,), dev)),
        "torch.empty": lambda: torch.empty(BLOCKS, 64, dtype=torch.int32,
                                           device=dev),
        "torch.cuda.device context": context,
        "dct_lut_f32 address": lambda: dct_lut_f32().ctypes.data,
        "cuda_stream": lambda: cuda_stream(dev),
        "load_library": kernels.load_library,
        "ctypes call and launch": lambda: lib.jt_fdct_exact(
            blocks.data_ptr(), qtable.data_ptr(), dct_lut_f32().ctypes.data,
            out.data_ptr(), BLOCKS, 8, stream),
        "whole wrapper": lambda: fdct_exact(blocks, qtable, 8),
    }
    for name, step in steps.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            step()
        us = (time.perf_counter() - t0) * 1e6 / REPS
        torch.cuda.synchronize()
        cs.log(f"wrapper fdct_exact step {name}: {us} us a call (host) "
               f"[{card}]")


if __name__ == "__main__":
    main()
