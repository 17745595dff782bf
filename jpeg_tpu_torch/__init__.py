"""jpeg_tpu_torch: the PyTorch/CUDA port of jpeg_tpu.

Motion-JPEG decode of restart-marker streams into pixels that stay on
the device (``DeviceDecoder``), and encode of device-resident frames into
restart-marker JPEG streams (``DeviceEncoder``, default or per-batch
optimized tables).  Every device stage is a hand-written CUDA kernel for
Hopper (``csrc/*.cu``), with a plain PyTorch version of each beside it
for the CPU.  The JAX package
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
from .encoder import EncodeParams
from .models.device_decode import DeviceDecoder
from .models.device_encode import DeviceEncoder

__version__ = "0.1.0"

__all__ = [
    "DeviceDecoder",
    "DeviceEncoder",
    "EncodeParams",
    "mjpeg",
    "JpegError",
    "UnsupportedError",
    "FileIOError",
    "NoMoreData",
    "CorruptStream",
    "__version__",
]
