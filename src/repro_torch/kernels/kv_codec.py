"""Per-block absmax int8 codec of the quantized KV cache.

The port's copy of the JAX package's ``repro.kernels.kv_codec`` blocked
entry points (plain torch there as here: jnp, no Pallas). Blocks run along
the trailing head dim, so each cached (position, kv-head) row carries its
own ``hd // block`` scales:

  - ``scale = absmax / 127 + 1e-12`` per block, in float32;
  - ``code = clip(round(x / scale), -127, 127)`` with a true division and
    ``torch.round``'s half-to-even, as ``jnp.round``;
  - ``dec = code * scale``.

The flat wire-format entry points (``enc_int8``/``dec_int8``) come with the
gradient-compression port.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def default_kv_block(head_dim: int) -> int:
    """The largest of (128, 64, 32) dividing ``head_dim``, else head_dim:
    scale leaves are ``(..., head_dim // block)`` with no padding, and the
    block is recoverable from the leaf shapes."""
    for b in (128, 64, 32):
        if head_dim % b == 0:
            return b
    return head_dim


def enc_int8_blocks(x: Tensor, block: int) -> Tuple[Tensor, Tensor]:
    """x (..., d), ``d % block == 0`` → (codes int8 (..., d), scales f32
    (..., d // block))."""
    d = x.shape[-1]
    if d % block:
        raise ValueError(f"trailing dim {d} is not a multiple of {block}")
    xb = x.float().reshape(*x.shape[:-1], d // block, block)
    scale = xb.abs().amax(dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    return q.to(torch.int8).reshape(x.shape), scale


def dec_int8_blocks(codes: Tensor, scales: Tensor, block: int) -> Tensor:
    """codes (..., d) int8, scales (..., d // block) → f32 (..., d)."""
    d = codes.shape[-1]
    cb = codes.float().reshape(*codes.shape[:-1], d // block, block)
    return (cb * scales.float()[..., None]).reshape(codes.shape)
