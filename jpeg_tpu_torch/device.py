"""Device selection and precision rules for the port.

Every public entry point takes an explicit ``device`` and passes it
through ``resolve``; nothing here picks a device on its own.  The
precision rules match the JAX package's ``precision="highest"`` matmuls
(``jpeg_tpu/ops/dct.py``): float32 products run in full float32, never
in TF32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .utils.metrics import trace


def set_precision() -> None:
    """Turn TF32 off for matmuls and cuDNN (fp32 end to end)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve(device) -> torch.device:
    """``device`` (str or torch.device) -> torch.device, with the precision
    rules applied.  A CUDA device without a usable card raises: work is
    never moved to the CPU instead."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False"
        )
    set_precision()
    return dev


def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev`` in a ``device_decode.upload`` span: a
    pageable copy to a card, the array itself on the CPU."""
    with trace("device_decode.upload"):
        return torch.from_numpy(a).to(dev)


def check_tensor(name: str, t: torch.Tensor, dtypes, shape,
                 device: torch.device) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous tensor on
    ``device`` with one of ``dtypes`` and exactly ``shape``: what a
    kernel wrapper checks before it hands ``t.data_ptr()`` to a kernel."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtypes} tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")


def cuda_stream(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
