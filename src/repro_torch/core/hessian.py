"""Calibration Hessian machinery (paper §3.2, eq. 9–14).

The layer Hessian is the Gram matrix of the layer inputs summed over all
calibration batches, ``H ≈ Σ_b X_bᵀX_b`` (eq. 9), damped by
``λ = percdamp · mean(diag H)`` (eq. 10). The Gram of each batch goes
through ``ops.hessian_accum`` (the CUDA kernel on the card, which adds into
``H`` in place). A stacked state (a routed-MoE layer's experts, one lane
each) adds each lane's Gram in one batched fp32 product, as the JAX
package computes it outside any Pallas kernel (an einsum at HIGHEST
precision; TF32 stays off on the card). Damping and the Cholesky
factorizations are library linear algebra in fp32, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
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
    """Add one calibration batch.

    Singleton state: x (..., in), leading dims flattened; on the card the
    state's H is updated in place by the kernel. Stacked state (B, in,
    in): x (B, ..., in), each lane's rows into its own Gram,
    ``H += x3ᵀx3`` per lane."""
    if state.H.dim() == 2:
        x2 = x.reshape(-1, x.shape[-1]).float()
        H = ops.hessian_accum(x2, state.H)
        return HessianState(H, state.count + x2.shape[0])
    b = state.H.shape[0]
    x3 = x.reshape(b, -1, x.shape[-1]).float()
    H = torch.baddbmm(state.H, x3.transpose(1, 2), x3)
    return HessianState(H, state.count + x3.shape[1])


def stack_states(states) -> HessianState:
    """Singleton states stacked into one (B, in, in) state, the counts
    (B,) int32."""
    return HessianState(
        torch.stack([s.H for s in states]),
        torch.stack([torch.as_tensor(s.count, dtype=torch.int32).reshape(())
                     for s in states]))


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


def corrupt_stacked(H: Tensor, mode: str, percdamp: float, lane: int = 0
                    ) -> Tensor:
    """The ``hessian.cholesky`` fault site's payload: one lane of a
    stacked (B, in, in) Gram matrix broken so that the guardrail ladder's
    rungs run (core/plan.py); returns a new tensor, the other lanes
    bitwise as they were.

    - ``"nonpsd"``: the lane's spectrum shifted by ``-(λmin + 2·lam)·I``
      (``lam = percdamp · mean(diag)``, λmin in fp64 on the host): the
      base damping leaves a negative eigenvalue (Cholesky → NaN), one
      damping escalation makes it positive again;
    - ``"nan"``: the lane NaN, which no damping rescues (the RTN rung)."""
    H = H[None] if H.dim() == 2 else H
    out = H.clone()
    if mode == "nan":
        out[lane] = float("nan")
        return out
    hl = H[lane].detach().cpu().numpy().astype(np.float64)
    lam = float(np.mean(np.diag(hl))) * percdamp
    ev_min = float(np.linalg.eigvalsh(hl)[0])
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    out[lane] = H[lane] + (-(ev_min + 2.0 * lam)) * eye
    return out


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


def block_solver(Hd: Tensor, c1: int, c2: int):
    """``solve(rhs)`` against the damped Hessian's diagonal block
    ``H̃[c1:c2, c1:c2]`` (eq. 12-14: stage 2's curvature), factored once."""
    return _cho_solver(torch.linalg.cholesky(Hd[c1:c2, c1:c2]))


def gram_solver(Xb: Tensor, damp_rel: float = 1e-6):
    """``solve(rhs)`` against ``X_bᵀX_b + λI`` with ``λ = damp_rel ·
    mean(diag G) + 1e-12`` (eq. 6 taken literally: one batch's Gram may be
    singular)."""
    G = Xb.T @ Xb
    lam = damp_rel * torch.mean(torch.diagonal(G)) + 1e-12
    return _cho_solver(torch.linalg.cholesky(
        G + lam * torch.eye(G.shape[0], dtype=G.dtype, device=G.device)))


def _cho_solver(L: Tensor):
    """``solve(rhs)`` by the lower factor ``L``; rhs (n,) or (n, k)."""
    def solve(rhs: Tensor) -> Tensor:
        if rhs.dim() == 1:
            return torch.cholesky_solve(rhs[:, None], L)[:, 0]
        return torch.cholesky_solve(rhs, L)
    return solve


def _cholesky_or_nan(A: Tensor) -> Tensor:
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


# -- distributed reduction / placement ---------------------------------------

def psum_hessian(state: HessianState, group) -> HessianState:
    """Partial Hessians summed over a process group (a mesh dim's:
    ``mesh.get_group("data")``), the same on every rank of it."""
    from repro_torch.distributed.sharding import psum
    return HessianState(psum(state.H, group), psum(state.count, group))


def shard_stacked(state: HessianState, gshard) -> HessianState:
    """This rank's lane block of a stacked (B, in, in) state, replicated
    over the rows' ``model`` dim: each lane's damp and Cholesky run where
    that lane's rows run. ``gshard``: a
    :class:`repro_torch.distributed.sharding.QuantGroupSharding`; None, or
    a rows-only group, keeps every lane. The block is a copy, so that the
    whole state can be freed."""
    if gshard is None or gshard.lane_axis is None:
        return state
    return HessianState(gshard.local(state.H, "hessian").clone(),
                        gshard.local(state.count, "lane").clone())
