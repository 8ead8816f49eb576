"""Deterministic synthetic data (torch tensors)."""
from repro_torch.data.synthetic import (DataState, MarkovLM,  # noqa: F401
                                        SentimentTask, calibration_batches)
