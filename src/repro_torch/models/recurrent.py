"""Recurrent sequence mixers: RG-LRU (recurrentgemma) and Mamba-1
(falcon-mamba), each over a full sequence and one decode step.

RG-LRU: the diagonal recurrence ``h_t = a_t ⊙ h_{t-1} + b_t`` runs, as in
the JAX package, over chunks of 1024 positions carrying h across them, and
within a chunk as a log-depth scan with the combine ``(a₁a₂, a₂b₁ + b₂)``
(here the doubling form: log2(chunk) rounds of fp32 elementwise products
over the whole chunk; the JAX package calls ``lax.associative_scan``, so
the two differ in the order of the products only). The reference runs no
kernel here and neither does the port. The reference asserts that a
sequence longer than a chunk is a multiple of it; the port carries h into
a shorter last chunk instead. The gates are fp32 (``sqrt(max(1 − a²,
1e-12))`` on the normalised input), the state's h is stored in the
compute dtype and read back as fp32.

Mamba-1: the full-sequence block (calibration, prefill) runs the diagonal
recurrence through ``ops.selective_scan``, the hand-written kernel on the
card; decode runs the single-step recurrence in plain PyTorch, as the JAX
package does.

The quantizable linears go through ``dense`` under the names
``{name}.in``, ``.gate``, ``.rg``, ``.ig`` and ``.out`` (RG-LRU) and
``{name}.in``, ``.x``, ``.dt`` and ``.out`` (Mamba), so calibration taps
and report names match the JAX package's; the conv taps are no dense and
are never calibrated.

State (per layer): RG-LRU ``{"conv": (B, K-1, W), "h": (B, W)}``, Mamba
``{"conv": (B, K-1, d_inner), "h": (B, d_inner, n)}``, both in the compute
dtype after the block, as in the JAX package. The block returns a new
state; a decode step writes its state into the tensors it was given
(rounded to the compute dtype first, as the JAX step rounds), so a
captured decode step reads and writes the same buffers on every replay.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import causal_conv1d, gelu, init_conv1d
from repro_torch.models.linear import dense, init_dense

Tensor = torch.Tensor


def softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) in its own order."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


# ---------------------------------------------------------------------------
# RG-LRU (recurrentgemma / Griffin)
# ---------------------------------------------------------------------------

RGLRU_C = 8.0
RGLRU_CHUNK = 1024


def _diag_recurrence(a: Tensor, b: Tensor, h0: Optional[Tensor]
                     ) -> Tensor:
    """h_t = a_t ⊙ h_{t-1} + b_t along axis 1; a/b (B, S, ...) fp32, h0
    (B, ...) folded into the first step. Doubling scan: after the round of
    offset d, position t holds the combine of positions (t - 2d, t]."""
    if h0 is not None:
        b = torch.cat([(b[:, :1] + a[:, :1] * h0[:, None]), b[:, 1:]], dim=1)
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < s:
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def _chunked_recurrence(a: Tensor, b: Tensor, h0: Tensor,
                        chunk: int = RGLRU_CHUNK) -> Tuple[Tensor, Tensor]:
    """The recurrence over chunks of ``chunk`` positions, h carried from
    one to the next. a/b (B, S, ...); h0 (B, ...). Returns (h (B, S, ...),
    h_last (B, ...))."""
    hs = []
    for c0 in range(0, a.shape[1], chunk):
        hc = _diag_recurrence(a[:, c0:c0 + chunk], b[:, c0:c0 + chunk], h0)
        h0 = hc[:, -1]
        hs.append(hc)
    return (hs[0] if len(hs) == 1 else torch.cat(hs, dim=1)), h0


def init_rglru_block(cfg: ModelConfig, gen: torch.Generator, device
                     ) -> Dict:
    d, w = cfg.d_model, cfg.rglru.lru_width
    # Λ such that a = sigmoid(Λ)^c lands in (0.9, 0.999)
    u = 0.9 + 0.099 * torch.rand((w,), generator=gen, device=device)
    root = u ** (1.0 / RGLRU_C)
    return {
        "in": init_dense(gen, d, w, device=device),
        "gate": init_dense(gen, d, w, device=device),
        "conv": init_conv1d(gen, cfg.rglru.conv1d_width, w, device),
        "rg": init_dense(gen, w, w, scale=w ** -0.5, device=device),
        "ig": init_dense(gen, w, w, scale=w ** -0.5, device=device),
        "lambda": torch.log(root / (1 - root)),
        "out": init_dense(gen, w, d, scale=w ** -0.5, device=device),
    }


def _rglru_gates(p: Dict, x: Tensor, name: str,
                 gate_in: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """(a, b) of the recurrence, fp32 (B, S, W): a = exp(-c · r ·
    softplus(-Λ)), b = sqrt(max(1 - a², 1e-12)) ⊙ (i ⊙ x), r and i the
    rg / ig products of ``gate_in`` (x where None). Where x holds a
    rank's channels (a sharded step's split) ``gate_in`` is the whole
    width, gathered over the ranks: rg / ig take every channel in and
    give the rank's out."""
    g = x if gate_in is None else gate_in
    r = torch.sigmoid(dense(p["rg"], g, f"{name}.rg").float())
    i = torch.sigmoid(dense(p["ig"], g, f"{name}.ig").float())
    a = torch.exp(-RGLRU_C * r * softplus(-p["lambda"].float()))
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * x.float())
    return a, b


def _rglru_in(p: Dict, x: Tensor, conv_state: Optional[Tensor], name: str):
    """The gate branch gelu(x W_gate), and the input branch x W_in through
    the causal conv: (gate, u, the conv's last K-1 inputs)."""
    gate = gelu(dense(p["gate"], x, f"{name}.gate"))
    u = dense(p["in"], x, f"{name}.in")
    u, conv_state = causal_conv1d(p["conv"], u, conv_state)
    return gate, u, conv_state


def rglru_block(cfg: ModelConfig, p: Dict, x: Tensor,
                state: Optional[Dict] = None, name: str = "rglru",
                reduce=None, gather=None) -> Tuple[Tensor, Dict]:
    """Full-sequence RG-LRU block. x (B, S, D); state None (zeros) or a
    state dict. Returns (y (B, S, D), the new state). Where ``cfg`` and
    ``p`` hold a rank's ``lru_width`` channels (a sharded step's split),
    ``gather`` makes the whole width of u for rg / ig from the ranks'
    channels and ``reduce`` sums the out product's fp32 partials
    (``linear.dense``); the recurrence is per channel."""
    gate, u, conv_state = _rglru_in(
        p, x, None if state is None else state["conv"], name)
    a, b = _rglru_gates(p, u, name, None if gather is None else gather(u))
    h0 = (torch.zeros_like(a[:, 0]) if state is None
          else state["h"].float())
    h, h_last = _chunked_recurrence(a, b, h0)
    y = dense(p["out"], h.to(x.dtype) * gate, f"{name}.out", reduce)
    # a copy: the view would keep the whole padded input alive in the state
    return y, {"conv": conv_state.clone(), "h": h_last.to(x.dtype)}


def rglru_decode(cfg: ModelConfig, p: Dict, x: Tensor, state: Dict,
                 name: str = "rglru") -> Tuple[Tensor, Dict]:
    """Single-token step. x (B, 1, D). Writes the new state into
    ``state``'s tensors and returns (y (B, 1, D), ``state``)."""
    gate, u, conv_state = _rglru_in(p, x, state["conv"], name)
    state["conv"].copy_(conv_state)
    a, b = _rglru_gates(p, u, name)                        # (B, 1, W)
    h = a[:, 0] * state["h"].float() + b[:, 0]
    y = dense(p["out"], h[:, None, :].to(x.dtype) * gate, f"{name}.out")
    state["h"].copy_(h.to(x.dtype))
    return y, state


def init_rglru_state(cfg: ModelConfig, batch: int, device,
                     dtype: torch.dtype = torch.bfloat16) -> Dict:
    w, k = cfg.rglru.lru_width, cfg.rglru.conv1d_width
    return {"conv": torch.zeros((batch, k - 1, w), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, w), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Mamba-1 (falcon-mamba)
# ---------------------------------------------------------------------------

def init_mamba_block(cfg: ModelConfig, gen: torch.Generator, device
                     ) -> Dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner = cfg.d_inner
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


def _x_projection(cfg: ModelConfig, p: Dict, u: Tensor, name: str,
                  reduce=None):
    """u (B, S, d_inner) post-conv → (dt (B, S, d_inner) f32, B, C (B, S,
    n) f32 views of the projection). ``reduce``: the x product's
    row-parallel sum, where u holds a rank's channels."""
    s = cfg.ssm
    proj = dense(p["x"], u, f"{name}.x", reduce).float()
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
    d_inner = cfg.d_inner
    xz = dense(p["in"], x, f"{name}.in")
    return xz[..., :d_inner], xz[..., d_inner:]


def mamba_block(cfg: ModelConfig, p: Dict, x: Tensor,
                state: Optional[Dict] = None, name: str = "mamba",
                reduce=None, x_reduce=None) -> Tuple[Tensor, Dict]:
    """Full-sequence Mamba block. x (B, S, D); state None (zeros) or a
    state dict. Returns (y (B, S, D), the new state). Where ``cfg`` and
    ``p`` hold a rank's ``d_inner`` channels (a sharded step's split),
    ``x_reduce`` sums the x projection's fp32 partials over the ranks and
    ``reduce`` the out product's (``linear.dense``)."""
    s = cfg.ssm
    d_inner = cfg.d_inner
    u, z = _split_in(cfg, p, x, name)
    u, conv_state = causal_conv1d(p["conv"], u,
                                  None if state is None else state["conv"])
    # a copy: the view would keep the whole padded input alive in the state
    conv_state = conv_state.clone()
    u = F.silu(u)
    dt, bm, cm = _x_projection(cfg, p, u, name, x_reduce)
    h0 = (torch.zeros((x.shape[0], d_inner, s.d_state), device=x.device)
          if state is None else state["h"].float())
    y, h_last = ops.selective_scan(u, dt, bm, cm, p["a_log"], p["d_skip"],
                                   h0)
    y = (y.float() * F.silu(z.float())).to(x.dtype)
    out = dense(p["out"], y, f"{name}.out", reduce)
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
    d_inner = cfg.d_inner
    return {"conv": torch.zeros((batch, s.d_conv - 1, d_inner), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, d_inner, s.d_state), dtype=dtype,
                             device=device)}
