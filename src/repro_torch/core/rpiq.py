"""RPIQ stage 2: residual-projected closed-loop refinement (paper §3.1–3.3).

Per linear ``Y = X Wᵀ`` and column block i, every Gauss–Seidel round takes
the directed residual ``D_i = Y_orig − (Y_q − Y_{q,i})`` (eq. 4/20), solves
``B_i* = H_i⁻¹ X_iᵀ D_i`` against the pre-factored block curvature
(eq. 13–14), projects onto the stage-1 grid (eq. 7), damps the update
``B_i ← B_i + α(B̃_i − B_i)`` (eq. 8) and refreshes ``Y_q`` at once
(eq. 21–22). Γ = ‖Y_orig − Y_q‖² (eq. 23) drives the early stop; the best
projected candidate is kept. The rounds run through ``ops.rpiq_block``
(the CUDA kernel on the card), which replays the stop and the best choice
from the raw round trajectory.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops

Tensor = torch.Tensor


class RPIQResult(NamedTuple):
    w_q: Tensor             # best projected (on-grid) weights
    w_cont: Tensor          # continuous iterate after t_max rounds
    loss_history: Tensor    # (t_max+1,) Γ per round, +inf after the stop
    proj_loss: Tensor       # Γ of the returned projected weights
    iters_run: Tensor       # rounds the closed loop executes


def _block_curvature_inv(x_last: Tensor, h_damped: Tensor,
                         h_count: Optional[Tensor], x_count: Optional[Tensor],
                         *, block_size: int, exact_gram: bool) -> Tensor:
    """Explicit block inverses H_i⁻¹, stacked: (B, M, bs, bs).

    x_last (B, n, in); h_damped (B, in, in); h_count/x_count (B,) or None.
    ``exact_gram=False`` (eq. 12–14) takes the block diagonals of the damped
    global Hessian rescaled by ``n_last / h_count`` to the single instance;
    ``True`` (eq. 6) the instance's own per-block Gram ``X_iᵀX_i`` with a
    light relative damping. Both factor by Cholesky and solve against I
    outside the refinement loop.
    """
    x = x_last.float()
    b, n, in_dim = x.shape
    if in_dim % block_size:
        raise ValueError(f"in={in_dim} is not a multiple of {block_size}")
    m = in_dim // block_size
    eye = torch.eye(block_size, dtype=torch.float32, device=x.device)
    if exact_gram:
        xb = x.reshape(b, n, m, block_size).permute(0, 2, 1, 3)
        blocks = xb.transpose(-1, -2) @ xb
        diag_mean = torch.diagonal(blocks, dim1=-2, dim2=-1).mean(dim=-1)
        blocks = blocks + (1e-4 * diag_mean + 1e-8)[..., None, None] * eye
    else:
        if h_count is None:
            h_scale = torch.ones((b,), device=x.device)
        else:
            n_x = (torch.full((b,), float(n), device=x.device)
                   if x_count is None else x_count.float())
            h_scale = n_x / torch.clamp(h_count.float(), min=1.0)
        h5 = (h_damped * h_scale[:, None, None]).reshape(
            b, m, block_size, m, block_size)
        blocks = torch.stack([h5[:, i, :, i, :] for i in range(m)], dim=1)
    chol = torch.linalg.cholesky_ex(blocks)[0]
    return torch.cholesky_solve(eye.expand_as(blocks), chol)


def rpiq_refine_batched(w_init: Tensor, w_fp: Tensor, x_last: Tensor,
                        h_damped: Tensor, scales: Tensor, zeros: Tensor, *,
                        h_count: Optional[Tensor] = None,
                        x_count: Optional[Tensor] = None, bits: int = 4,
                        group_size: int = 128, block_size: int = 128,
                        alpha: float = 0.01, t_max: int = 5,
                        early_stop: bool = True, exact_gram: bool = False,
                        symmetric: bool = False,
                        loss_psum_group=None) -> RPIQResult:
    """Stage 2 over a stacked group: w_init/w_fp (B, out, in), x_last
    (B, n, in), h_damped (B, in, in), scales/zeros (B, out, groups),
    h_count/x_count (B,) or None. Every member keeps its own early stop.
    ``loss_psum_group``: a row shard's peers (``ops.rpiq_block``)."""
    hinv = _block_curvature_inv(x_last, h_damped, h_count, x_count,
                                block_size=block_size, exact_gram=exact_gram)
    return RPIQResult(*ops.rpiq_block(
        w_init, w_fp, x_last, hinv, scales, zeros, bits=bits,
        group_size=group_size, block_size=block_size, alpha=alpha,
        t_max=t_max, early_stop=early_stop, symmetric=symmetric,
        loss_psum_group=loss_psum_group))


def rpiq_refine(w_init: Tensor, w_fp: Tensor, x_last: Tensor,
                h_damped: Tensor, scales: Tensor, zeros: Tensor, *,
                h_count: Optional[Tensor] = None,
                x_count: Optional[Tensor] = None, **kw) -> RPIQResult:
    """Stage 2 for one linear: w_init/w_fp (out, in), x_last (n, in)."""
    hc = None if h_count is None else h_count.reshape(1)
    xc = None if x_count is None else x_count.reshape(1)
    res = rpiq_refine_batched(w_init[None], w_fp[None], x_last[None],
                              h_damped[None], scales[None], zeros[None],
                              h_count=hc, x_count=xc, **kw)
    return RPIQResult(*(r[0] for r in res))
