"""Device resolution for the port's entry points.

Entry points run on the CUDA card by default. Without a card they raise
unless the caller asked for the CPU explicitly (``device="cpu"``, as the
CPU tests do): a run never drops to the CPU on its own.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` without an index is
    the rank's card under ``torch.distributed.run``
    (``cuda:{LOCAL_RANK % device_count}``, made current), else card 0."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions")
        if dev.index is None and "LOCAL_RANK" in os.environ:
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                               % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        # the reference pins its fp32 products at full precision, and its
        # bf16 products (the MoE experts') accumulate in fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    return dev
