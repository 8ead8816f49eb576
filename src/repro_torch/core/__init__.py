"""repro_torch.core."""
