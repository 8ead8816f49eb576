"""Multi-head self-attention: forward, prefill, decode.

The math mirrors the JAX package's ``opt_attention`` path: queries are
pre-scaled in fp32 and cast to the compute dtype, scores and values are
products of compute-dtype operands accumulated in fp32, softmax runs in
fp32 with masked slots at -1e30. The products are plain matmuls and a
softmax (no fused attention operator). Caches are the bf16 full cache
(B, S_max, H, hd); a slot's key position is -1 until it is written.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import apply_rope
from repro_torch.models.linear import dense, init_dense

Tensor = torch.Tensor
NEG_INF = -1e30


def _mm(a: Tensor, b: Tensor) -> Tensor:
    """Product of compute-dtype operands with fp32 accumulation."""
    return a.float() @ b.float()


def _attend_chunked(q: Tensor, k: Tensor, v: Tensor, q_positions: Tensor,
                    kv_positions: Tensor, chunk: int = 512) -> Tensor:
    """Causal attention. q/k/v (B, S, H, hd); positions (B, Sq) / (B, Sk).
    Queries go in chunks of ``chunk``; each chunk takes a full softmax over
    the keys. Returns (B, Sq, H, hd) in q's dtype."""
    b, sq, h, hd = q.shape
    scale = hd ** -0.5
    kT = k.permute(0, 2, 3, 1)                      # (B, H, hd, Sk)
    vT = v.permute(0, 2, 1, 3)                      # (B, H, Sk, hd)
    dk = kv_positions[:, None, None, :]
    outs = []
    for c0 in range(0, sq, chunk):
        qi = q[:, c0:c0 + chunk]
        pi = q_positions[:, c0:c0 + chunk]
        qs = (qi.float() * scale).to(qi.dtype).permute(0, 2, 1, 3)
        s = _mm(qs, kT)                             # (B, H, c, Sk)
        dq = pi[:, None, :, None]
        mask = (dq >= 0) & (dk >= 0) & (dq >= dk)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        o = _mm(p.to(vT.dtype), vT)                 # (B, H, c, hd)
        outs.append(o.permute(0, 2, 1, 3).to(q.dtype))
    return torch.cat(outs, dim=1)


def init_attention(cfg: ModelConfig, gen: torch.Generator, bias: bool,
                   device) -> Dict:
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {"q": init_dense(gen, d, h * hd, bias=bias, device=device),
            "k": init_dense(gen, d, h * hd, bias=bias, device=device),
            "v": init_dense(gen, d, h * hd, bias=bias, device=device),
            "o": init_dense(gen, h * hd, d, bias=bias,
                            scale=(h * hd) ** -0.5, device=device)}


def _project_qkv(cfg: ModelConfig, p: Dict, x: Tensor, name: str):
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = dense(p["q"], x, f"{name}.q").reshape(b, s, h, hd)
    k = dense(p["k"], x, f"{name}.k").reshape(b, s, h, hd)
    v = dense(p["v"], x, f"{name}.v").reshape(b, s, h, hd)
    return q, k, v


def attention_forward(cfg: ModelConfig, p: Dict, x: Tensor,
                      positions: Tensor, *, name: str = "attn") -> Tensor:
    """Causal self-attention over a full sequence. x (B, S, D)."""
    q, k, v = _project_qkv(cfg, p, x, name)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = _attend_chunked(q, k, v, positions, positions)
    b, s = x.shape[:2]
    return dense(p["o"], o.reshape(b, s, -1), f"{name}.o")


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device, dtype: torch.dtype = torch.bfloat16) -> Dict:
    shape = (batch, max_len, cfg.num_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_prefill(cfg: ModelConfig, p: Dict, x: Tensor,
                      positions: Tensor, cache: Dict, *, name: str = "attn"
                      ) -> Tuple[Tensor, Dict]:
    """Causal attention over the prompt and the cache write at [0, S).
    The cache is written in place."""
    q, k, v = _project_qkv(cfg, p, x, name)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = _attend_chunked(q, k, v, positions, positions)
    b, s = x.shape[:2]
    y = dense(p["o"], o.reshape(b, s, -1), f"{name}.o")
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    return y, cache


def cache_key_positions(pos: Tensor, cache_len: int) -> Tensor:
    """(B, cache_len) position held by each full-cache slot once ``pos``
    was written: the slot index while <= pos, else -1."""
    idx = torch.arange(cache_len, device=pos.device)[None, :]
    return torch.where(idx <= pos[:, None], idx, torch.full_like(idx, -1))


def attention_decode(cfg: ModelConfig, p: Dict, x: Tensor, pos: Tensor,
                     cache: Dict, *, name: str = "attn"
                     ) -> Tuple[Tensor, Dict]:
    """One-token decode against the full cache. x (B, 1, D); pos (B,).
    The new K/V row is written into the cache in place."""
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _project_qkv(cfg, p, x, name)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    bidx = torch.arange(b, device=x.device)
    ck[bidx, pos] = k[:, 0].to(ck.dtype)
    cv[bidx, pos] = v[:, 0].to(cv.dtype)
    kpos = cache_key_positions(pos, ck.shape[1])
    qg = (q[:, 0] * hd ** -0.5).reshape(b, h, 1, hd).to(ck.dtype)
    s = _mm(qg, ck.permute(0, 2, 3, 1))             # (B, H, 1, S)
    s = torch.where(kpos[:, None, None, :] >= 0, s,
                    torch.full_like(s, NEG_INF))
    pw = torch.softmax(s, dim=-1)
    o = _mm(pw.to(cv.dtype), cv.permute(0, 2, 1, 3)).to(x.dtype)
    y = dense(p["o"], o.reshape(b, 1, h * hd), f"{name}.o")
    return y, cache
