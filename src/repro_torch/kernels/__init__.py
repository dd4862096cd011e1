"""Hand-written Hopper kernels and their plain PyTorch versions.

``moe_gemm`` (grouped and ragged expert GEMMs), ``flash_attention`` and
``ssd`` (the Mamba2 SSD intra-chunk term) each hold a ``ref`` module (the plain versions) and an ``ops`` module
(the wrappers).  A wrapper launches its CUDA kernel for CUDA tensors,
takes the plain version only for CPU tensors, and raises otherwise.
"""

from repro_torch.kernels._build import build, launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import ops as _fa_ops  # noqa: F401  (registers its kernel)
from repro_torch.kernels.moe_gemm import ops as _mm_ops  # noqa: F401
from repro_torch.kernels.ssd import ops as _ssd_ops  # noqa: F401

__all__ = ["build", "launch_counts", "reset_launch_counts"]
