"""repro_torch.serving."""
