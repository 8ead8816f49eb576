"""Shared model layers: norms, MLP, embeddings, rotary embeddings,
whisper's sinusoidal positions, the depthwise causal conv of the Mamba
block.

Plain functions over param dicts. Compute dtype follows the input; norm
statistics and RoPE run in float32, as in the JAX package. Under a
sharded step's ``model`` split (``sharding.use_split``) :func:`embed` is
vocab-parallel: the rank holds a block of the embedding's rows.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import current_split, reduce_from_model
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


def gelu(x: Tensor) -> Tensor:
    """``jax.nn.gelu`` (the tanh approximation) in its own order, every
    step and constant in x's dtype: ``x * (0.5 * (1 + tanh(√(2/π) * (x +
    0.044715 * x³))))``. In bf16 that rounds √(2/π) to 0.796875 and each
    step, which a fused gelu computing in fp32 does not (it differs from
    the reference's on ~43 % of bf16 inputs; this form on none)."""
    def k(v: float) -> float:
        # the constant rounded to x's dtype, on the host (no device copy,
        # so a captured decode step holds it)
        return float(torch.tensor(v, dtype=x.dtype))
    inner = (x + x ** 3 * k(0.044715)) * k(math.sqrt(2 / math.pi))
    return x * ((torch.tanh(inner) + 1.0) * 0.5)


def _act(name: str, x: Tensor) -> Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return gelu(x)
    raise ValueError(name)


def mlp(cfg: ModelConfig, p: Dict, x: Tensor, name: str = "mlp",
        reduce=None) -> Tensor:
    """Gated (llama-style) or plain two-layer MLP; ``reduce``: ``down``'s
    row-parallel sum (``linear.dense``)."""
    if cfg.gated_mlp:
        h = _act(cfg.act, dense(p["gate"], x, f"{name}.gate")) \
            * dense(p["up"], x, f"{name}.up")
    else:
        h = _act(cfg.act, dense(p["up"], x, f"{name}.up"))
    return dense(p["down"], h, f"{name}.down", reduce)


def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_model: int, d_ff: int,
             bias: bool, device) -> Dict:
    p = {"up": init_dense(gen, d_model, d_ff, bias=bias, device=device),
         "down": init_dense(gen, d_ff, d_model, bias=bias,
                            scale=d_ff ** -0.5, device=device)}
    if cfg.gated_mlp:
        p["gate"] = init_dense(gen, d_model, d_ff, bias=bias, device=device)
    return p


def embed(p: Dict, tokens: Tensor, dtype: torch.dtype) -> Tensor:
    """The rows of the embedding cast to ``dtype``, a gather (bitwise
    indexing); its backward on CUDA sums each row's gradients in a fixed
    order (no atomics), so a training run repeats bitwise.

    Vocab-parallel under a ``model`` split that covers the vocab: the
    rank holds rows ``[i·n, (i+1)·n)``, gathers those of its tokens,
    writes zeros for the others and the rows are summed over the axis in
    fp32 (exact: one term is not zero), then cast."""
    split = current_split()
    if split is None or not split.vocab:
        return F.embedding(tokens, p["embedding"].to(dtype))
    w = p["embedding"]
    local = tokens - split.index * w.shape[0]
    own = (local >= 0) & (local < w.shape[0])
    rows = F.embedding(torch.where(own, local, 0), w).float()
    rows = torch.where(own[..., None], rows, 0.0)
    return reduce_from_model(rows, split.ag.group).to(dtype)


def unembed(cfg: ModelConfig, params: Dict, h: Tensor) -> Tensor:
    """Final projection to fp32 vocab logits, then the logits soft cap
    ``tanh(l / c) * c`` when ``logits_softcap`` > 0. Untied: the
    ``lm_head`` dense; tied: ``h @ embedding.T`` with the embedding in h's
    dtype and fp32 accumulation. Both are plain matmuls (the head is not
    quantized)."""
    if cfg.tie_embeddings:
        w = params["embed"]["embedding"].to(h.dtype)         # (V, D)
        logits = h.float() @ w.float().T
    else:
        logits = dense(params["lm_head"], h).float()
    return tanh_softcap(logits, cfg.logits_softcap)


def tanh_softcap(x: Tensor, cap: float) -> Tensor:
    """``tanh(x / cap) * cap`` when ``cap`` > 0, else x."""
    return torch.tanh(x / cap) * cap if cap > 0 else x


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


def sinusoidal_positions(seq_len: int, d_model: int, device="cpu"
                         ) -> Tensor:
    """Whisper's fixed sinusoidal table: (seq_len, d_model) f32, the
    ``[sin | cos]`` halves of ``pos / 10000^(2i / d_model)``, as the JAX
    package builds it; the caller casts it to the compute dtype."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=device)[None, :]
    ang = pos / (10000.0 ** (dim / d_model))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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
