from repro_torch.kernels.ssd import ops, ref  # noqa: F401
