"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA present and no explicit CPU request they raise instead of falling
back silently.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``.  Raises if CUDA is asked for but absent.

    On the card, float32 matmuls and convolutions are pinned to full fp32
    (no TF32): the kernels' fp32 contract and the parity probes assume it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
