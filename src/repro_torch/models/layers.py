"""Shared model layers: norms, MLP, embeddings, rotary embeddings, the
depthwise causal conv of the Mamba block.

Plain functions over param dicts. Compute dtype follows the input; norm
statistics and RoPE run in float32, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.linear import dense, init_dense

Tensor = torch.Tensor


def rmsnorm(p: Dict, x: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * (1.0 + p["scale"].float())).to(x.dtype)


def layernorm(p: Dict, x: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def norm(cfg: ModelConfig, p: Dict, x: Tensor) -> Tensor:
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


def init_norm(cfg: ModelConfig, d: int, device) -> Dict:
    if cfg.norm == "rmsnorm":
        return {"scale": torch.zeros((d,), device=device)}
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def _act(name: str, x: Tensor) -> Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":                  # jax.nn.gelu: the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def mlp(cfg: ModelConfig, p: Dict, x: Tensor, name: str = "mlp") -> Tensor:
    """Gated (llama-style) or plain two-layer MLP."""
    if cfg.gated_mlp:
        h = _act(cfg.act, dense(p["gate"], x, f"{name}.gate")) \
            * dense(p["up"], x, f"{name}.up")
    else:
        h = _act(cfg.act, dense(p["up"], x, f"{name}.up"))
    return dense(p["down"], h, f"{name}.down")


def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_model: int, d_ff: int,
             bias: bool, device) -> Dict:
    p = {"up": init_dense(gen, d_model, d_ff, bias=bias, device=device),
         "down": init_dense(gen, d_ff, d_model, bias=bias,
                            scale=d_ff ** -0.5, device=device)}
    if cfg.gated_mlp:
        p["gate"] = init_dense(gen, d_model, d_ff, bias=bias, device=device)
    return p


def embed(p: Dict, tokens: Tensor, dtype: torch.dtype) -> Tensor:
    return p["embedding"].to(dtype)[tokens]


def unembed(cfg: ModelConfig, params: Dict, h: Tensor) -> Tensor:
    """Final projection to fp32 vocab logits (a plain matmul: lm_head is
    not quantized)."""
    return dense(params["lm_head"], h).float()


def init_embed(gen: torch.Generator, vocab: int, d: int, device) -> Dict:
    return {"embedding": torch.randn((vocab, d), generator=gen,
                                     device=device) * 0.02}


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10000.0
               ) -> Tensor:
    """x (B, S, H, hd); positions (B, S). Half-split (not interleaved)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = positions.float()[..., None] * inv
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def causal_conv1d(p: Dict, x: Tensor, state: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv over the sequence, as the JAX package's.

    x (B, S, C); p["w"] (K, C) taps; p["b"] (C,); state (B, K-1, C) the
    trailing inputs of the previous call, or None (zeros). The taps are
    cast to x's dtype, the K products summed in fp32 in tap order, then
    the bias added. Returns (y (B, S, C) in x's dtype, the last K-1 inputs
    (B, K-1, C) in x's dtype): a view of the padded input, which the caller
    copies (a new state) or copies into the state it passed (decode).
    """
    w = p["w"].to(x.dtype)
    k = w.shape[0]
    b, s, c = x.shape
    if state is None:
        state = x.new_zeros((b, k - 1, c))
    xp = torch.cat([state.to(x.dtype), x], dim=1)           # (B, S+K-1, C)
    y = torch.zeros((b, s, c), dtype=torch.float32, device=x.device)
    for j in range(k):
        y = y + xp[:, j:j + s].float() * w[j].float()
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype), xp[:, s:]


def init_conv1d(gen: torch.Generator, width: int, channels: int, device,
                bias: bool = True) -> Dict:
    p = {"w": torch.randn((width, channels), generator=gen, device=device)
         * width ** -0.5}
    if bias:
        p["b"] = torch.zeros((channels,), device=device)
    return p
