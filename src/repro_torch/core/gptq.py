"""GPTQ stage 1: one-shot blockwise greedy quantization (paper §3.1).

Faithful to Frantar et al. / AutoGPTQ and to the JAX package: the damped
Hessian H̃, U = upper Cholesky factor of H̃⁻¹, columns left to right in lazy
blocks with in-block error propagation scaled by U[j, j+1:]/U[j, j], a
rank-blocksize tail update at block end, and group (scale, zero) refreshed
from the error-compensated weights at group entry. The sweep runs through
``ops.gptq_block`` (the CUDA kernel on the card).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import hessian as hess
from repro_torch.core.quant import (compute_qparams, dequantize_codes,
                                    quantize_codes)
from repro_torch.kernels import ops

Tensor = torch.Tensor


class GPTQResult(NamedTuple):
    w_q: Tensor         # (out, in) dequantized quantized weights (f32)
    scales: Tensor      # (out, in // group_size)
    zeros: Tensor       # (out, in // group_size), integer-valued
    err: Tensor         # Σ err² (diagnostic)


def gptq_quantize(w: Tensor, hinv_u: Tensor, *, bits: int = 4,
                  group_size: int = 128, blocksize: int = 128,
                  symmetric: bool = False) -> GPTQResult:
    """Quantize ``w`` (out, in) given U = ``hinv_u``."""
    return GPTQResult(*ops.gptq_block(
        w, hinv_u, bits=bits, group_size=group_size, blocksize=blocksize,
        symmetric=symmetric))


def gptq_quantize_batched(w: Tensor, hinv_u: Tensor, *, bits: int = 4,
                          group_size: int = 128, blocksize: int = 128,
                          symmetric: bool = False) -> GPTQResult:
    """One sweep over a stacked group: w (B, out, in), hinv_u (B, in, in)."""
    if w.dim() != 3 or hinv_u.dim() != 3:
        raise ValueError(f"expected stacked inputs, got {tuple(w.shape)}, "
                         f"{tuple(hinv_u.shape)}")
    return gptq_quantize(w, hinv_u, bits=bits, group_size=group_size,
                         blocksize=blocksize, symmetric=symmetric)


def gptq_from_hessian(w: Tensor, H: hess.HessianState, *, bits: int = 4,
                      group_size: int = 128, blocksize: int = 128,
                      percdamp: float = 0.01,
                      symmetric: bool = False) -> GPTQResult:
    """Damp H, factor, quantize. w: (out, in)."""
    u = hess.cholesky_inverse_upper(hess.damped(H, percdamp))
    return gptq_quantize(w, u, bits=bits, group_size=group_size,
                         blocksize=blocksize, symmetric=symmetric)


def rtn_quantize(w: Tensor, *, bits: int = 4, group_size: int = 128,
                 symmetric: bool = False) -> GPTQResult:
    """Round-to-nearest baseline (no Hessian) in GPTQResult form."""
    qp = compute_qparams(w, bits, group_size, symmetric)
    q = quantize_codes(w, qp, bits, group_size, symmetric)
    dq = dequantize_codes(q, qp, group_size, symmetric)
    return GPTQResult(dq, qp.scales, qp.zeros,
                      torch.zeros((), device=w.device))


def rtn_quantize_batched(w: Tensor, *, bits: int = 4, group_size: int = 128,
                         symmetric: bool = False) -> GPTQResult:
    """RTN over a stacked (B, out, in) block (row-wise, so the stack folds
    into the row axis)."""
    b, o, i = w.shape
    res = rtn_quantize(w.reshape(b * o, i), bits=bits, group_size=group_size,
                       symmetric=symmetric)
    return GPTQResult(res.w_q.reshape(b, o, i), res.scales.reshape(b, o, -1),
                      res.zeros.reshape(b, o, -1),
                      torch.zeros((b,), device=w.device))
