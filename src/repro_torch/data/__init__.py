"""Deterministic synthetic calibration data (torch tensors)."""
from repro_torch.data.synthetic import MarkovLM, calibration_batches  # noqa: F401
