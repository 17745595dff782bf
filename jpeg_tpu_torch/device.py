"""Device selection and precision rules for the port.

Every public entry point takes an explicit ``device`` and passes it
through ``resolve``; nothing here picks a device on its own.  The
precision rules match the JAX package's ``precision="highest"`` matmuls
(``jpeg_tpu/ops/dct.py``): float32 products run in full float32, never
in TF32.
"""

from __future__ import annotations

import torch


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
