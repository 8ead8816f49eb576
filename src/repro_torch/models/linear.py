"""Tappable, quantization-aware dense layer.

Every matmul the quantizer can touch goes through :func:`dense`, decided
by the value stored under ``"w"``:

  - a float tensor of shape (in, out): ``x @ w`` with fp32 accumulation,
    cast back to x's dtype; a row-parallel product (sharded training's
    ``model`` axis) sums its fp32 partials over the ranks first
    (``reduce``);
  - a :class:`~repro_torch.core.quant.QuantizedTensor` (packed int4,
    (out, in)-major): the W4A16 path through ``ops.w4a16_matmul``;
  - inside a :class:`Tap` context the layer's input is recorded by name,
    which is how calibration collects Hessians and the single instance.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core.quant import QuantizedTensor, dequantize_packed
from repro_torch.kernels import ops

Tensor = torch.Tensor

_ACTIVE_TAPS: List["Tap"] = []


class Tap:
    """Context manager that calls ``on_record(name, x)`` with the input of
    every named dense layer that runs inside it."""

    def __init__(self, on_record: Callable[[str, Tensor], None]):
        self.record = on_record

    def __enter__(self) -> "Tap":
        _ACTIVE_TAPS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE_TAPS.remove(self)


def dense(p: Dict, x: Tensor, name: str = "",
          reduce: Optional[Callable[[Tensor], Tensor]] = None) -> Tensor:
    """y = x @ w (+ b). p: {"w": (in, out) tensor | QuantizedTensor, "b"?}.
    ``reduce`` (float weights): applied to the fp32 product before the
    cast, the sum of a row-parallel product's partials
    (``sharding.ModelSplit.row_reduce``); the bias is added after it."""
    w = p["w"]
    if name:
        for tap in _ACTIVE_TAPS:
            tap.record(name, x)
    if isinstance(w, QuantizedTensor):
        y = ops.w4a16_matmul(x, w.packed, w.scales, w.zeros,
                             group_size=w.group_size)
    else:
        y = x.float() @ w.to(x.dtype).float()
        if reduce is not None:
            y = reduce(y)
        y = y.to(x.dtype)
    if p.get("b") is not None:
        y = y + p["b"].to(y.dtype)
    return y


def init_dense(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: Optional[float] = None,
               device: torch.device = torch.device("cpu")) -> Dict:
    if scale is None:
        scale = d_in ** -0.5
    p = {"w": torch.randn((d_in, d_out), generator=gen, device=device)
         * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device)
    return p


def dense_weight_oi(p: Dict) -> Tensor:
    """The (out, in)-major float view the quantizer consumes."""
    w = p["w"]
    if isinstance(w, QuantizedTensor):
        return dequantize_packed(w)
    return w.T
