"""Per-block absmax int8 codec: the quantized KV cache and the gradient
wire format.

The port's copy of the JAX package's ``repro.kernels.kv_codec`` (plain
torch there as here: jnp, no Pallas), one scheme for two consumers:

  - the KV cache's blocked entry points: blocks run along the trailing
    head dim, so each cached (position, kv-head) row carries its own
    ``hd // block`` scales;
  - the flat wire format of ``distributed/compression.py``
    (:func:`enc_int8` / :func:`dec_int8`): the raveled tensor zero-padded
    to blocks of :data:`WIRE_BLOCK`.

Both:

  - ``scale = absmax / 127 + 1e-12`` per block, in float32;
  - ``code = clip(round(x / scale), -127, 127)`` with a true division and
    ``torch.round``'s half-to-even, as ``jnp.round``;
  - ``dec = code * scale``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# the flat entry points' block (the gradient wire format's)
WIRE_BLOCK = 256


def enc_int8(g: Tensor, block: int = WIRE_BLOCK) -> Tuple[Tensor, Tensor]:
    """Flat encode: ravel, zero-pad to a block multiple, quantize each
    block → (codes int8 (nb, block), scales f32 (nb,))."""
    flat = g.reshape(-1)
    n = flat.numel()
    nb = -(-n // block)
    flat = F.pad(flat, (0, nb * block - n)).reshape(nb, block)
    absmax = flat.abs().amax(dim=1)
    scale = absmax / torch.full_like(absmax, 127.0) + 1e-12
    q = torch.clamp(torch.round(flat / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale.float()


def dec_int8(q: Tensor, scale: Tensor, shape,
             block: int = WIRE_BLOCK) -> Tensor:
    """Flat decode: dequantize, drop the padding tail, restore ``shape``
    (the codes carry the block as their trailing dim)."""
    del block
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


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
