"""Device resolution for the port's entry points.

Entry points run on the CUDA card by default. Without a card they raise
unless the caller asked for the CPU explicitly (``device="cpu"``, as the
CPU tests do): a run never drops to the CPU on its own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions")
        # the reference pins its fp32 products at full precision
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
