"""repro_torch.kernels."""
