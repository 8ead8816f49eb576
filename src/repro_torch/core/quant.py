"""Quantization grid primitives: group-wise low-bit quantization.

Conventions (GPTQ / AutoGPTQ, as in the JAX package):
  - weights quantize along the *input* dimension in groups of group_size;
  - asymmetric: q = clip(round(w/scale) + zero, 0, 2^bits-1),
                dq = scale * (q - zero);
  - symmetric:  q = clip(round(w/scale), -2^(b-1), 2^(b-1)-1), zero = 0;
  - storage packs two 4-bit codes per uint8 along the input dim, low nibble
    = even column.

Shapes: W (out, in); scales/zeros (out, in/group_size) f32; packed
(out, in/2) uint8. ``torch.round`` rounds halves to even like ``jnp.round``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

Tensor = torch.Tensor


class QuantParams(NamedTuple):
    scales: Tensor      # (out, n_groups) f32
    zeros: Tensor       # (out, n_groups) f32, integer-valued


class QuantizedTensor:
    """A packed quantized weight matrix (the serving artifact), stored
    (out, in)-major like GPTQ. Leading dims stack matrices: a routed-MoE
    layer's experts are one tensor of (E, out, in//2) codes with (E, out,
    n_groups) scales and zeros, ``shape`` (E, out, in)."""

    def __init__(self, packed: Tensor, scales: Tensor, zeros: Tensor,
                 shape: Tuple[int, ...], bits: int, group_size: int):
        self.packed = packed        # (..., out, in//2) uint8
        self.scales = scales        # (..., out, n_groups) f32
        self.zeros = zeros          # (..., out, n_groups) f32
        self.shape = tuple(int(s) for s in shape)
        self.bits = int(bits)
        self.group_size = int(group_size)

    def __repr__(self):
        return (f"QuantizedTensor(shape={self.shape}, bits={self.bits}, "
                f"group_size={self.group_size})")


def quantized_leaves(tree, path: str = ""):
    """(dotted path, QuantizedTensor) of every packed linear weight in a
    params tree, wherever it sits (attention, MLP or Mamba mixer; a Mamba
    mixer's conv, a_log and d_skip are not packed and are not visited)."""
    if isinstance(tree, QuantizedTensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from quantized_leaves(v, f"{path}.{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from quantized_leaves(v, f"{path}.{i}" if path else str(i))


def compute_qparams(w: Tensor, bits: int, group_size: int,
                    symmetric: bool = False) -> QuantParams:
    """The RTN grid. The divisors are tensors: on CUDA torch divides by a
    Python scalar through its reciprocal, one ulp off the true division
    of the CPU and the reference."""
    out_dim, in_dim = w.shape
    if in_dim % group_size:
        raise ValueError(f"in={in_dim} is not a multiple of {group_size}")
    g = w.float().reshape(out_dim, in_dim // group_size, group_size)
    qmax = 2.0 ** bits - 1.0
    if symmetric:
        absmax = g.abs().amax(dim=-1)
        scale = torch.clamp(
            absmax / torch.full_like(absmax, 2.0 ** (bits - 1) - 1),
            min=1e-8)
        return QuantParams(scale, torch.zeros_like(scale))
    wmax = torch.clamp(g.amax(dim=-1), min=0.0)
    wmin = torch.clamp(g.amin(dim=-1), max=0.0)
    scale = torch.clamp((wmax - wmin) / torch.full_like(wmax, qmax),
                        min=1e-8)
    zero = torch.clamp(torch.round(-wmin / scale), 0.0, qmax)
    return QuantParams(scale, zero)


def quantize_codes(w: Tensor, qp: QuantParams, bits: int, group_size: int,
                   symmetric: bool = False) -> Tensor:
    """Integer codes (int32) of ``w`` on the grid ``qp``."""
    scale = qp.scales.repeat_interleave(group_size, dim=1)
    zero = qp.zeros.repeat_interleave(group_size, dim=1)
    if symmetric:
        lo, hi = -(2.0 ** (bits - 1)), 2.0 ** (bits - 1) - 1
        q = torch.clamp(torch.round(w.float() / scale), lo, hi)
    else:
        q = torch.clamp(torch.round(w.float() / scale) + zero, 0.0,
                        2.0 ** bits - 1.0)
    return q.to(torch.int32)


def dequantize_codes(q: Tensor, qp: QuantParams, group_size: int,
                     symmetric: bool = False,
                     dtype: torch.dtype = torch.float32) -> Tensor:
    scale = qp.scales.repeat_interleave(group_size, dim=1)
    if symmetric:
        return (q.float() * scale).to(dtype)
    zero = qp.zeros.repeat_interleave(group_size, dim=1)
    return ((q.float() - zero) * scale).to(dtype)


def fake_quantize(w: Tensor, bits: int, group_size: int,
                  symmetric: bool = False,
                  qp: QuantParams | None = None) -> Tensor:
    """Quantize then dequantize (the paper's ``Q(.)``, eq. 7), in w's
    dtype: on the grid ``qp`` when given (a fixed grid), else on the RTN
    grid of ``w`` itself."""
    if qp is None:
        qp = compute_qparams(w, bits, group_size, symmetric)
    q = quantize_codes(w, qp, bits, group_size, symmetric)
    return dequantize_codes(q, qp, group_size, symmetric, dtype=w.dtype)


def quantize_column(w_col: Tensor, scale: Tensor, zero: Tensor, bits: int,
                    symmetric: bool = False) -> Tensor:
    """Quantize then dequantize one column (out,) on per-row ``scale`` /
    ``zero`` (out,), the step of a column-by-column GPTQ loop."""
    if symmetric:
        lo, hi = -(2.0 ** (bits - 1)), 2.0 ** (bits - 1) - 1
        return torch.clamp(torch.round(w_col / scale), lo, hi) * scale
    q = torch.clamp(torch.round(w_col / scale) + zero, 0.0,
                    2.0 ** bits - 1.0)
    return (q - zero) * scale


def quant_error(w: Tensor, bits: int, group_size: int,
                symmetric: bool = False) -> Tensor:
    """The Frobenius norm of ``w``'s round-to-nearest error (a
    diagnostic)."""
    return torch.linalg.norm(w - fake_quantize(w, bits, group_size,
                                               symmetric))


def pack_int4(q: Tensor) -> Tensor:
    """Codes in [0, 15], (out, in) → (out, in//2) uint8, low nibble = even
    column."""
    if q.shape[-1] % 2:
        raise ValueError("pack_int4 needs an even input dimension")
    q = q.to(torch.uint8)
    return (q[:, 0::2] | (q[:, 1::2] << 4)).contiguous()


def unpack_int4(packed: Tensor) -> Tensor:
    """Inverse of :func:`pack_int4` → (out, in) int32 codes."""
    lo = (packed & 0x0F).to(torch.int32)
    hi = (packed >> 4).to(torch.int32)
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[0],
                                                 packed.shape[1] * 2)


def pack_quantized(w: Tensor, bits: int, group_size: int,
                   symmetric: bool = False) -> QuantizedTensor:
    """Round-to-nearest quantize → pack: the serving artifact of ``w``."""
    if bits != 4:
        raise ValueError("packed storage supports 4-bit only")
    qp = compute_qparams(w, bits, group_size, symmetric)
    q = quantize_codes(w, qp, bits, group_size, symmetric)
    zeros = qp.zeros
    if symmetric:                       # shift to unsigned storage
        q = q + 8
        zeros = qp.zeros + 8.0
    return QuantizedTensor(pack_int4(q), qp.scales, zeros, tuple(w.shape),
                           bits, group_size)


def dequantize_packed(qt: QuantizedTensor,
                      dtype: torch.dtype = torch.float32) -> Tensor:
    q = unpack_int4(qt.packed)
    return dequantize_codes(q, QuantParams(qt.scales, qt.zeros),
                            qt.group_size, symmetric=False, dtype=dtype)
