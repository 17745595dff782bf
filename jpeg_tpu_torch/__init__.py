"""jpeg_tpu_torch: the PyTorch/CUDA port of jpeg_tpu.

Motion-JPEG decode of restart-marker streams into pixels that stay on
the device, with the restart-segment entropy decode as a hand-written
CUDA kernel for Hopper (``csrc/decode_segments.cu``) and a plain PyTorch
version of every kernel beside it for the CPU.  The JAX package
``jpeg_tpu`` is the reference the port is held against; this package
never imports jax.
"""

from . import mjpeg
from .errors import (
    CorruptStream,
    FileIOError,
    JpegError,
    NoMoreData,
    UnsupportedError,
)
from .models.device_decode import DeviceDecoder

__version__ = "0.1.0"

__all__ = [
    "DeviceDecoder",
    "mjpeg",
    "JpegError",
    "UnsupportedError",
    "FileIOError",
    "NoMoreData",
    "CorruptStream",
    "__version__",
]
