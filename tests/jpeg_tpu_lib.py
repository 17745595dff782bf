"""Build jpeg_tpu's native library once across pytest-xdist workers.

jpeg_tpu's loader runs ``make`` when ``libjpegtpu.so`` is missing, and make
writes the file in place: a worker that loads the file while another
worker still writes it fails, and the loader remembers that failure for
the rest of its process, so every native test on that worker fails.
``build_once`` builds under a file lock into a scratch directory and
renames the finished file into place, so no process sees it half written.
The port's test modules that load jpeg_tpu's library call it when they
are collected; every worker collects every module before it runs a test,
so the library is whole before any test of any worker loads it.  jpeg_tpu
is not changed: where the build fails (no toolchain), its loader builds
and fails as before.
"""

import fcntl
import os
import subprocess
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NATIVE = ROOT / "jpeg_tpu" / "native"
LIB = NATIVE / "libjpegtpu.so"


def build_once() -> None:
    """Build ``jpeg_tpu/native/libjpegtpu.so`` with jpeg_tpu's Makefile if
    it is missing, one process at a time, and move it into place whole."""
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with open(build / "jpeg_tpu_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if LIB.exists():
            return
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            try:
                res = subprocess.run(
                    ["make", "-s", "-C", tmp, "-f", str(NATIVE / "Makefile"),
                     f"VPATH={NATIVE}", LIB.name],
                    capture_output=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired):
                return
            out = Path(tmp) / LIB.name
            if res.returncode == 0 and out.exists():
                os.replace(out, LIB)
