"""Probe the symbol histogram (K7) on a card: how a warp counts its
symbols, and how many blocks' loads it keeps in flight.

Run from the repository root on a machine with a CUDA card:

    python3 tools/hist_probe.py

Builds a copy of ``csrc/encode_scan.cu`` for each (counting, ``UNROLL``)
of ``VARIANTS`` (one nvcc each, all started together, under
``build/hist_probe/``, with ``-Xptxas -v``; the engine's own build is not
touched) and launches each build's ``jt_hist_blocks`` on the blocks of the
8-frame 1080p bench chunk (chip_smoke's phase 10 input: the dense stage of
the 8 bench frames at restart interval 4).  Each build's histogram must
equal ``hist_from_blocks_ref``.  Its time: 20 back-to-back launches, CUDA
events (``ms``) and device-only (``device_ms``: the 20 launches in one
CUDA graph), three times each.  Counting: ``shared``, the source's own,
lane atomics into one shared histogram a CTA; ``warp``, a histogram a
warp, summed at the CTA's end; ``elect``, the lanes of one bin elect one
that adds their number (``__match_any_sync``).  The card's name and power
limit lead the output, then the registers ptxas gives each build's
kernel, then one JSON line a build.
"""

import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from jpeg_tpu_torch import kernels  # noqa: E402
from jpeg_tpu_torch.device import cuda_stream, set_precision  # noqa: E402
from jpeg_tpu_torch.entropy.encode_cuda import block_histogram  # noqa: E402
from jpeg_tpu_torch.entropy.encode_torch import (  # noqa: E402
    hist_from_blocks_ref,
)
from jpeg_tpu_torch.models.device_encode import DeviceEncoder  # noqa: E402

# (counting, UNROLL); the source's own is ("shared", 4)
VARIANTS = [("shared", 2), ("shared", 4), ("shared", 8), ("shared", 16),
            ("warp", 4), ("warp", 8), ("elect", 4), ("elect", 8)]
SOURCE = kernels.CSRC / "encode_scan.cu"
PROBE_DIR = kernels.BUILD_DIR.parent / "hist_probe"

# The source's lines that each counting other than "shared" replaces.
COUNTING = {
    "shared": [],
    "warp": [
        ("  for (int i = threadIdx.x; i < bins; i += blockDim.x) h[i] = 0;",
         "  for (int i = threadIdx.x; i < HIST_WARPS * bins; "
         "i += blockDim.x)\n    h[i] = 0;"),
        ("  Count count{h, lane};", "  Count count{h + warp * bins, lane};"),
        ("    if (h[i]) atomicAdd(&hist[i], h[i]);",
         "  {\n    int sum = 0;\n"
         "    for (int w = 0; w < HIST_WARPS; ++w) sum += h[w * bins + i];\n"
         "    if (sum) atomicAdd(&hist[i], sum);\n  }"),
        ("  const size_t shared = static_cast<size_t>(T) * 256 * "
         "sizeof(int32_t);",
         "  const size_t shared =\n      static_cast<size_t>(HIST_WARPS) * "
         "T * 256 * sizeof(int32_t);"),
    ],
    "elect": [
        ("    if (sa >= 0) atomicAdd(h + sa, 1);\n"
         "    if (sb >= 0) atomicAdd(h + sb, 1);\n",
         "    const unsigned pa = __match_any_sync(FULL, sa);\n"
         "    if (sa >= 0 && lane == __ffs(pa) - 1) "
         "atomicAdd(h + sa, __popc(pa));\n"
         "    const unsigned pb = __match_any_sync(FULL, sb);\n"
         "    if (sb >= 0 && lane == __ffs(pb) - 1) "
         "atomicAdd(h + sb, __popc(pb));\n"),
    ],
}


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{SOURCE.name}: expected one {old!r}")
    return text.replace(old, new)


def probe_source(counting: str, unroll: int) -> str:
    """encode_scan.cu with its counting and UNROLL replaced."""
    text = _replace(SOURCE.read_text(), "constexpr int UNROLL = 4;",
                    f"constexpr int UNROLL = {unroll};")
    for old, new in COUNTING[counting]:
        text = _replace(text, old, new)
    return text


def probe_library(variants: list) -> dict:
    """Build (one nvcc each, all started together) and load a probe build
    for each (counting, unroll) -> {(counting, unroll): (lib, ptxas lines
    of the histogram kernel)}."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, procs = kernels._nvcc(), []
    header = (kernels.CSRC / "resident.cuh").read_text()
    flags = [*kernels.NVCC_FLAGS, "-Xptxas", "-v", f"-I{kernels.CSRC}"]
    for counting, unroll in variants:
        text = probe_source(counting, unroll)
        tag = hashlib.sha256((" ".join(flags) + text + header).encode())
        so = PROBE_DIR / f"hist_{counting}_{unroll}_{tag.hexdigest()[:12]}.so"
        src = so.with_suffix(".cu")
        src.write_text(text)
        procs.append(((counting, unroll), so, subprocess.Popen(
            [nvcc, *flags, "-shared", "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    p, i = ctypes.c_void_p, ctypes.c_int
    out = {}
    for key, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so.name}:\n{log}")
        lines = log.splitlines()
        at = [k for k, ln in enumerate(lines) if "hist_blocks" in ln]
        usage = [ln.strip() for k in at for ln in lines[k:k + 3]
                 if re.search(r"registers|spill|bytes stack", ln)]
        lib = ctypes.CDLL(str(so))
        lib.jt_hist_blocks.argtypes = [p, p, p, i, i, p, p]
        lib.jt_hist_blocks.restype = i
        out[key] = (lib, usage)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("hist_probe: needs a CUDA card")
    card = cs.card_label()
    cs.log(card)
    set_precision()
    kernels.load_library()
    dev = torch.device("cuda")
    enc = DeviceEncoder.for_config(1080, 1920, 3, cs.BENCH_PARAMS, device=dev)
    zz = enc.dense(cs.bench_pixels(dev)[:cs.CHUNK])
    _, _, dc_tab, ac_tab = enc.chunk_tables(cs.CHUNK)
    T = len(enc.table_keys)
    ref = hist_from_blocks_ref(zz, dc_tab, ac_tab, T)
    hist = torch.zeros(T, 256, dtype=torch.int32, device=dev)
    builds = probe_library(VARIANTS)
    for (counting, unroll), (_, usage) in builds.items():
        cs.log(f"ptxas {counting} UNROLL={unroll}: {usage}")
    runs = [("engine", lambda: block_histogram(zz, dc_tab, ac_tab, T))]
    for (counting, unroll), (lib, _) in builds.items():
        def launch(lib=lib):
            rc = lib.jt_hist_blocks(zz.data_ptr(), dc_tab.data_ptr(),
                                    ac_tab.data_ptr(), T, zz.shape[0],
                                    hist.data_ptr(), cuda_stream(dev))
            if rc != 0:
                raise RuntimeError(f"hist_blocks launch failed: {rc}")
            return hist
        runs.append((f"{counting} unroll {unroll}", launch))
    for label, run in runs:
        hist.zero_()
        if not torch.equal(run(), ref):
            raise AssertionError(f"{label}: the histogram differs from the "
                                 "plain version's")
        rec = {"build": label, "blocks": int(zz.shape[0]), "T": T,
               "ms": [cs.cuda_ms(run, 20) for _ in range(3)],
               "device_ms": [cs.device_ms(run, 20) for _ in range(3)],
               "card": card}
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
