"""Communication compression: block-wise int8 with per-block absmax scales.

The port of ``repro.core.compression``: a 1-byte payload and one fp32
scale a block of 256 values, the scheme the pipeline's hand-offs use with
``MeshPlan.compress_p2p`` (``core.pipeline``: the int8 payload and its
scales cross the wire, the receiver dequantises to the payload's dtype).
The pod axis is the slowest link of the production mesh, and activations
and their cotangents tolerate 8-bit transport.  ``ef_compress`` is the
error-feedback step for gradient streams.

Bit for bit the reference's: ``torch.round`` rounds half to even as
``jnp.round`` does, and the blocks are divided by the safe scale (not
multiplied by its reciprocal).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

BLOCK = 256


def _blocks(flat: torch.Tensor, block: int) -> torch.Tensor:
    """The flat fp32 values zero-padded to whole blocks, (nblocks, block)."""
    pad = (-flat.numel()) % block
    return F.pad(flat.float(), (0, pad)).reshape(-1, block)


def quantize_int8(x: torch.Tensor, block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise absmax int8 quantisation over the flattened tensor.
    Returns (q int8 of x.shape, scales fp32 of (nblocks,))."""
    blocks = _blocks(x.reshape(-1), block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return q.reshape(-1)[:x.numel()].reshape(x.shape), scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, block: int = BLOCK,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The inverse of :func:`quantize_int8` up to its rounding, in ``dtype``."""
    blocks = _blocks(q.reshape(-1), block) * scale[:, None]
    return blocks.reshape(-1)[:q.numel()].reshape(q.shape).to(dtype)


def ef_compress(g: torch.Tensor, residual: Optional[torch.Tensor], block: int = BLOCK
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback compression step: returns (q, scale, new_residual).
    The caller transports (q, scale) and carries new_residual locally."""
    if residual is not None:
        g = g + residual.to(g.dtype)
    q, scale = quantize_int8(g, block)
    approx = dequantize_int8(q, scale, block, g.dtype)
    return q, scale, (g - approx).float()
