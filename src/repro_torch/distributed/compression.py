"""Gradient all-reduce over a data parallel group with optional
compression and error feedback.

The twin of the JAX package's ``distributed/compression.py``. Two codecs:

  - ``bf16``: gradients rounded to bfloat16 before the sum (2× fewer
    bytes on a bf16 wire);
  - ``int8``: the flat per-block absmax codec of ``kernels/kv_codec.py``
    (:data:`~repro_torch.kernels.kv_codec.WIRE_BLOCK` = 256), 4× fewer.

Both keep an error-feedback accumulator ``e ← g − dec(enc(g + e))``, so
the compression bias does not accumulate over steps. As in the reference,
the sum runs over the decoded values (``psum(recon) / n``; a ring
all-reduce of the payloads sums the same values), in f32.

The reference's train step never calls it, and no module of the JAX
package reads ``parallel.grad_compression``; the port's step does not
either (ROADMAP.md, "Deliberately without a twin").
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import AxisGroup, psum
from repro_torch.kernels import kv_codec
from repro_torch.training.optimizer import tree_leaves, tree_map

Tensor = torch.Tensor


def compress_psum(grads: Any, group: Any, method: str = "none",
                  err: Optional[Any] = None) -> Tuple[Any, Any]:
    """The mean of ``grads`` (a tree of tensors) over ``group``'s ranks —
    a process group, or the :class:`~repro_torch.distributed.sharding.
    AxisGroup` of a mesh dim — with ``method`` ``"none"``, ``"bf16"`` or
    ``"int8"``; returns ``(mean_grads, new_err)`` (``err`` passed through
    under ``"none"``, zeros when None otherwise)."""
    if isinstance(group, AxisGroup):
        group = group.group
    n = dist.get_world_size(group)

    def mean(t: Tensor) -> Tensor:
        s = psum(t, group)
        return s / torch.full_like(s, n)

    if method == "none":
        return tree_map(mean, grads), err
    if method not in ("bf16", "int8"):
        raise ValueError(method)
    if err is None:
        err = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device), grads)

    def one(g: Tensor, e: Tensor) -> Tuple[Tensor, Tensor]:
        gf = g.float() + e
        if method == "bf16":
            recon = gf.to(torch.bfloat16).float()
        else:
            q, s = kv_codec.enc_int8(gf)
            recon = kv_codec.dec_int8(q, s, gf.shape)
        return mean(recon), gf - recon

    outs = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(err))]
    it_red, it_err = iter([o[0] for o in outs]), iter([o[1] for o in outs])
    return (tree_map(lambda _: next(it_red), grads),
            tree_map(lambda _: next(it_err), grads))
