"""jpeg_tpu_torch: the PyTorch/CUDA port of jpeg_tpu.

Motion-JPEG decode into pixels that stay on the device
(``DeviceDecoder``, ``mjpeg.decode_stream_device``: any restart layout,
and streams without restart markers through the speculative engine,
``decode_frame_rstless``),
encode of device-resident frames into restart-marker JPEG streams
(``DeviceEncoder``, default or per-batch optimized tables), and the
single-image API (``decode_jpeg``, ``decode_coefficients``,
``encode_jpeg``, ``decode_frame_device``; the exact mode is
byte-identical to the reference codec).  Every function takes an
explicit device.  Every device stage is a hand-written CUDA kernel for
Hopper (``csrc/*.cu``), with a plain PyTorch version of each beside it
for the CPU.  The JAX package ``jpeg_tpu`` is the reference the port is
held against; this package never imports jax.
"""

from . import mjpeg
from .api import DecodedImage, decode_coefficients, decode_jpeg
from .errors import (
    CorruptStream,
    FileIOError,
    JpegError,
    NoMoreData,
    UnsupportedError,
)
from .encoder import EncodeParams, encode_jpeg
from .mjpeg import warm_stream_device
from .models.device_decode import (
    DeviceDecoder,
    decode_frame_device,
    decode_frame_rstless,
)
from .models.device_encode import DeviceEncoder

__version__ = "0.1.0"

__all__ = [
    "decode_jpeg",
    "decode_coefficients",
    "DecodedImage",
    "encode_jpeg",
    "decode_frame_device",
    "decode_frame_rstless",
    "warm_stream_device",
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
