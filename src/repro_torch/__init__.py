"""PyTorch/CUDA port of the FedDCT system, beside the JAX package.

Same layout and names as ``repro`` so the two can be read module
against module.  This package imports ``torch`` and numpy only: never
``jax`` and nothing of ``repro``.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``.  Raises when a CUDA device is asked for (or
    defaulted to) and none is present: the CPU is used only on request."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def set_full_f32() -> None:
    """Full-precision f32 products: cuDNN convolutions default to TF32,
    which would let the looped (``_conv``) and batched (``_conv_im2col``)
    paths drift apart on the card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
