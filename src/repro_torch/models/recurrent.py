"""Mamba-1 sequence mixer (falcon-mamba): full sequence and one-step decode.

The full-sequence block (calibration, prefill) runs the diagonal
recurrence through ``ops.selective_scan``, the hand-written kernel on the
card; decode runs the single-step recurrence in plain PyTorch, as the JAX
package does. The quantizable linears go through ``dense`` under the
names ``{name}.in``, ``.x``, ``.dt`` and ``.out``, so calibration taps and
report names match the JAX package's. The RG-LRU half of the JAX module
waits in ROADMAP.md's port queue.

State (per layer): ``{"conv": (B, K-1, d_inner), "h": (B, d_inner, n)}``,
both in the compute dtype after the block, as in the JAX package. The
block returns a new state; a decode step writes its state into the tensors
it was given (rounded to the compute dtype first, as the JAX step rounds),
so a captured decode step reads and writes the same buffers on every
replay.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import causal_conv1d, init_conv1d
from repro_torch.models.linear import dense, init_dense

Tensor = torch.Tensor


def softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) in its own order."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def init_mamba_block(cfg: ModelConfig, gen: torch.Generator, device
                     ) -> Dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    a = torch.arange(1, s.d_state + 1, dtype=torch.float32,
                     device=device)[None, :].expand(d_inner, s.d_state)
    return {
        "in": init_dense(gen, d, 2 * d_inner, device=device),
        "conv": init_conv1d(gen, s.d_conv, d_inner, device),
        "x": init_dense(gen, d_inner, s.dt_rank + 2 * s.d_state,
                        device=device),
        "dt": init_dense(gen, s.dt_rank, d_inner, bias=True, device=device),
        "a_log": torch.log(a).contiguous(),          # (d_inner, d_state)
        "d_skip": torch.ones((d_inner,), device=device),
        "out": init_dense(gen, d_inner, d, scale=d_inner ** -0.5,
                          device=device),
    }


def _x_projection(cfg: ModelConfig, p: Dict, u: Tensor, name: str):
    """u (B, S, d_inner) post-conv → (dt (B, S, d_inner) f32, B, C (B, S,
    n) f32 views of the projection)."""
    s = cfg.ssm
    proj = dense(p["x"], u, f"{name}.x").float()
    dt, bm, cm = torch.split(proj, [s.dt_rank, s.d_state, s.d_state],
                             dim=-1)
    dt = softplus(dense(p["dt"], dt.to(u.dtype), f"{name}.dt").float())
    return dt, bm, cm


def _mamba_ssm_inputs(cfg: ModelConfig, p: Dict, u: Tensor, name: str):
    """The decode step's recurrence terms (a, b, C) of
    ``h_t = a ⊙ h_{t-1} + b``; b is (dt·B)·u, in the JAX package's order."""
    dt, bm, cm = _x_projection(cfg, p, u, name)
    A = -torch.exp(p["a_log"].float())                     # (d_inner, n)
    a = torch.exp(dt[..., None] * A[None, None])           # (B, S, d, n)
    b = (dt[..., None] * bm[:, :, None, :]) * u.float()[..., None]
    return a, b, cm


def _split_in(cfg: ModelConfig, p: Dict, x: Tensor, name: str):
    d_inner = cfg.ssm.expand * cfg.d_model
    xz = dense(p["in"], x, f"{name}.in")
    return xz[..., :d_inner], xz[..., d_inner:]


def mamba_block(cfg: ModelConfig, p: Dict, x: Tensor,
                state: Optional[Dict] = None, name: str = "mamba"
                ) -> Tuple[Tensor, Dict]:
    """Full-sequence Mamba block. x (B, S, D); state None (zeros) or a
    state dict. Returns (y (B, S, D), the new state)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    u, z = _split_in(cfg, p, x, name)
    u, conv_state = causal_conv1d(p["conv"], u,
                                  None if state is None else state["conv"])
    # a copy: the view would keep the whole padded input alive in the state
    conv_state = conv_state.clone()
    u = F.silu(u)
    dt, bm, cm = _x_projection(cfg, p, u, name)
    h0 = (torch.zeros((x.shape[0], d_inner, s.d_state), device=x.device)
          if state is None else state["h"].float())
    y, h_last = ops.selective_scan(u, dt, bm, cm, p["a_log"], p["d_skip"],
                                   h0)
    y = (y.float() * F.silu(z.float())).to(x.dtype)
    out = dense(p["out"], y, f"{name}.out")
    return out, {"conv": conv_state, "h": h_last.to(x.dtype)}


def mamba_decode(cfg: ModelConfig, p: Dict, x: Tensor, state: Dict,
                 name: str = "mamba") -> Tuple[Tensor, Dict]:
    """Single-token step. x (B, 1, D). Writes the new state into
    ``state``'s tensors and returns (y (B, 1, D), ``state``)."""
    u, z = _split_in(cfg, p, x, name)
    u, conv_state = causal_conv1d(p["conv"], u, state["conv"])
    state["conv"].copy_(conv_state)
    u = F.silu(u)
    a, b, cm = _mamba_ssm_inputs(cfg, p, u, name)          # (B, 1, d, n)
    h = a[:, 0] * state["h"].float() + b[:, 0]             # (B, d, n)
    y = torch.einsum("bdn,bn->bd", h, cm[:, 0])
    y = y + u[:, 0].float() * p["d_skip"].float()
    # y is rounded to the compute dtype before the gate, where the scan
    # rounds its output
    y = y.to(x.dtype).float()
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)
    out = dense(p["out"], y[:, None, :], f"{name}.out")
    state["h"].copy_(h.to(x.dtype))
    return out, state


def init_mamba_state(cfg: ModelConfig, batch: int, device,
                     dtype: torch.dtype = torch.bfloat16) -> Dict:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return {"conv": torch.zeros((batch, s.d_conv - 1, d_inner), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, d_inner, s.d_state), dtype=dtype,
                             device=device)}
