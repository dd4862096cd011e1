"""PyTorch + CUDA port of the Piper MoE system for NVIDIA Hopper.

Mirrors the layout of the JAX package ``repro`` module for module, imports
nothing of it, and runs its hot kernels as hand-written CUDA C++ compiled
for ``sm_90a`` (``repro_torch.kernels``).  Entry points run on ``cuda``
unless the caller asks for ``device="cpu"``.
"""
