"""Calibration Hessian machinery (paper §3.2, eq. 9–14).

The layer Hessian is the Gram matrix of the layer inputs summed over all
calibration batches, ``H ≈ Σ_b X_bᵀX_b`` (eq. 9), damped by
``λ = percdamp · mean(diag H)`` (eq. 10). The Gram of each batch goes
through ``ops.hessian_accum`` (the CUDA kernel on the card, which adds into
``H`` in place). Damping and the Cholesky factorizations are library linear
algebra in fp32, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from repro_torch.kernels import ops

Tensor = torch.Tensor


class HessianState(NamedTuple):
    """Gram accumulator of one linear (H (in, in), count ()) or of a stack
    of same-shape linears (H (B, in, in), count (B,))."""
    H: Tensor
    count: Tensor


def init_hessian(in_dim: int, batch: Optional[int] = None,
                 device: Union[str, torch.device] = "cpu") -> HessianState:
    if batch is None:
        return HessianState(torch.zeros((in_dim, in_dim), device=device),
                            torch.zeros((), dtype=torch.int32, device=device))
    return HessianState(torch.zeros((batch, in_dim, in_dim), device=device),
                        torch.zeros((batch,), dtype=torch.int32,
                                    device=device))


def accumulate(state: HessianState, x: Tensor) -> HessianState:
    """Add one calibration batch to a singleton state; x (..., in).

    On the card the state's H is updated in place."""
    if state.H.dim() != 2:
        raise ValueError("accumulate takes a singleton (in, in) state")
    x2 = x.reshape(-1, x.shape[-1]).float()
    H = ops.hessian_accum(x2, state.H)
    return HessianState(H, state.count + x2.shape[0])


def damped(state: HessianState, percdamp) -> Tensor:
    """eq. 10: H̃ = H + percdamp·mean(diag H)·I; dead columns get diag 1.

    Works on singleton and stacked states; ``percdamp`` may be a scalar or
    a per-lane (B,) tensor."""
    H = state.H
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    if not isinstance(percdamp, torch.Tensor):
        percdamp = torch.tensor(percdamp, dtype=torch.float32,
                                device=H.device)
    lam = diag.mean(dim=-1) * percdamp
    dead = diag <= 0.0
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    H = H + torch.where(dead, 1.0, 0.0)[..., None, :] * eye
    return H + lam[..., None, None] * eye


def cholesky_inverse_upper(Hd: Tensor) -> Tensor:
    """GPTQ's ``Hinv``: the upper Cholesky factor U of H̃⁻¹ (H̃⁻¹ = UᵀU).

    chol → inverse by a Cholesky solve against I → chol → transpose, the
    formula of the JAX package. Accepts (in, in) or stacked (B, in, in).
    A lane whose factorization fails comes out NaN, as in JAX, so that the
    caller's finiteness check can name it."""
    L = _cholesky_or_nan(Hd)
    eye = torch.eye(Hd.shape[-1], dtype=Hd.dtype, device=Hd.device)
    hinv = torch.cholesky_solve(eye.expand_as(Hd), L)
    return _cholesky_or_nan(hinv).transpose(-1, -2)


def _cholesky_or_nan(A: Tensor) -> Tensor:
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)
