"""repro_torch.models."""
