"""Grouped-query self-attention: forward, prefill, decode.

The math mirrors the JAX package's ``opt_attention`` path: queries are
pre-scaled in fp32 and cast to the compute dtype, scores and values are
products of compute-dtype operands accumulated in fp32, softmax runs in
fp32 with masked slots at -1e30. The products are plain matmuls and a
softmax (no fused attention operator). Query head h reads kv-head
``h // n_rep`` (``n_rep = num_heads // num_kv_heads``), the order of
``repeat_kv``.

Caches (per layer, full length; a slot's key position is -1 until it is
written) are written in place:

  - bf16: ``{"k", "v"}`` (B, S_max, KV, hd);
  - int8 (``serve.kv_cache=int8``): ``"k"``/``"v"`` int8 codes at the same
    shapes, per-(slot, kv-head, block) f32 scales ``"k_scale"``/
    ``"v_scale"`` (B, S_max, KV, hd // block) with block
    ``kv_codec.default_kv_block(hd)``, and per-lane f32 error-feedback
    accumulators ``"k_err"``/``"v_err"`` (B, KV, hd) that decode appends
    fold in (``e <- x - dec(enc(x + e))``). Decode reads the history
    through ``ops.int8_kv_attention``.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import kv_codec, ops
from repro_torch.models.layers import apply_rope
from repro_torch.models.linear import dense, init_dense

Tensor = torch.Tensor
NEG_INF = -1e30


def repeat_kv(k: Tensor, n_rep: int) -> Tensor:
    """(B, S, KV, hd) → (B, S, KV*n_rep, hd)."""
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(
        b, s, kv * n_rep, hd)


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
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"q": init_dense(gen, d, h * hd, bias=bias, device=device),
            "k": init_dense(gen, d, kv * hd, bias=bias, device=device),
            "v": init_dense(gen, d, kv * hd, bias=bias, device=device),
            "o": init_dense(gen, h * hd, d, bias=bias,
                            scale=(h * hd) ** -0.5, device=device)}


def _project_qkv(cfg: ModelConfig, p: Dict, x: Tensor, name: str):
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(p["q"], x, f"{name}.q").reshape(b, s, h, hd)
    k = dense(p["k"], x, f"{name}.k").reshape(b, s, kv, hd)
    v = dense(p["v"], x, f"{name}.v").reshape(b, s, kv, hd)
    return q, k, v


def _n_rep(cfg: ModelConfig) -> int:
    return cfg.num_heads // cfg.num_kv_heads


def attention_forward(cfg: ModelConfig, p: Dict, x: Tensor,
                      positions: Tensor, *, name: str = "attn") -> Tensor:
    """Causal self-attention over a full sequence. x (B, S, D)."""
    q, k, v = _project_qkv(cfg, p, x, name)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    n_rep = _n_rep(cfg)
    o = _attend_chunked(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                        positions, positions)
    b, s = x.shape[:2]
    return dense(p["o"], o.reshape(b, s, -1), f"{name}.o")


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                  dtype: Union[torch.dtype, str] = torch.bfloat16) -> Dict:
    """``dtype`` is a torch dtype, or ``"int8"`` for the quantized layout
    (codes + scales + error-feedback accumulators, module docstring)."""
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (batch, max_len, kv, hd)
    if dtype == "int8":
        nb = hd // kv_codec.default_kv_block(hd)
        f32 = dict(dtype=torch.float32, device=device)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros((batch, max_len, kv, nb), **f32),
                "k_err": torch.zeros((batch, kv, hd), **f32),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_scale": torch.zeros((batch, max_len, kv, nb), **f32),
                "v_err": torch.zeros((batch, kv, hd), **f32)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_quantized(cache: Dict) -> bool:
    """True for the int8 codes + scales layout."""
    return "k_scale" in cache


def kv_cache_block(cache: Dict) -> int:
    """Codec block of a quantized cache, recovered from its leaf shapes."""
    return cache["k"].shape[-1] // cache["k_scale"].shape[-1]


def attention_prefill(cfg: ModelConfig, p: Dict, x: Tensor,
                      positions: Tensor, cache: Dict, *, name: str = "attn"
                      ) -> Tuple[Tensor, Dict]:
    """Causal attention over the prompt and the cache write at [0, S).
    Queries attend to the fresh float K/V, not to the cache, so the cache
    layout does not move the prefill output. The cache is written in
    place; the int8 layout's error accumulators stay untouched (error
    feedback is a decode-append recurrence)."""
    q, k, v = _project_qkv(cfg, p, x, name)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    n_rep = _n_rep(cfg)
    o = _attend_chunked(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                        positions, positions)
    b, s = x.shape[:2]
    y = dense(p["o"], o.reshape(b, s, -1), f"{name}.o")
    if kv_cache_quantized(cache):
        blk = kv_cache_block(cache)
        cache["k"][:, :s], cache["k_scale"][:, :s] = \
            kv_codec.enc_int8_blocks(k, blk)
        cache["v"][:, :s], cache["v_scale"][:, :s] = \
            kv_codec.enc_int8_blocks(v, blk)
    else:
        cache["k"][:, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :s] = v.to(cache["v"].dtype)
    return y, cache


def cache_key_positions(pos: Tensor, cache_len: int) -> Tensor:
    """(B, cache_len) position held by each full-cache slot once ``pos``
    was written: the slot index while <= pos, else -1."""
    idx = torch.arange(cache_len, device=pos.device)[None, :]
    return torch.where(idx <= pos[:, None], idx, torch.full_like(idx, -1))


def _prescaled_groups(q: Tensor, kv: int) -> Tensor:
    """(B, H, hd) decode queries → (B, KV, n_rep, hd) times hd^-0.5 in q's
    dtype: the scale is rounded to that dtype first and the product back
    to it, as JAX multiplies an array by a Python float."""
    b, h, hd = q.shape
    scale = float(torch.tensor(hd ** -0.5, dtype=q.dtype))
    return (q * scale).reshape(b, kv, h // kv, hd)


def attention_decode(cfg: ModelConfig, p: Dict, x: Tensor, pos: Tensor,
                     cache: Dict, *, name: str = "attn"
                     ) -> Tuple[Tensor, Dict]:
    """One-token decode against the full cache. x (B, 1, D); pos (B,).
    The new K/V row is written into the cache in place; on the int8
    layout it is appended with error feedback and the history is read by
    ``ops.int8_kv_attention``."""
    b = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(cfg, p, x, name)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    bidx = torch.arange(b, device=x.device)
    kpos = cache_key_positions(pos, ck.shape[1])
    qg = _prescaled_groups(q[:, 0], kv)
    if kv_cache_quantized(cache):
        blk = kv_cache_block(cache)
        for leaf, new in (("k", k), ("v", v)):
            xf = new[:, 0].float() + cache[f"{leaf}_err"]
            codes, scales = kv_codec.enc_int8_blocks(xf, blk)
            cache[leaf][bidx, pos] = codes
            cache[f"{leaf}_scale"][bidx, pos] = scales
            cache[f"{leaf}_err"].copy_(
                xf - kv_codec.dec_int8_blocks(codes, scales, blk))
        o = ops.int8_kv_attention(qg, ck, cache["k_scale"], cv,
                                  cache["v_scale"], kpos.to(torch.int32),
                                  kv_block=blk).to(x.dtype)
    else:
        ck[bidx, pos] = k[:, 0].to(ck.dtype)
        cv[bidx, pos] = v[:, 0].to(cv.dtype)
        s = _mm(qg.to(ck.dtype), ck.permute(0, 2, 3, 1))  # (B, KV, R, S)
        s = torch.where(kpos[:, None, None, :] >= 0, s,
                        torch.full_like(s, NEG_INF))
        pw = torch.softmax(s, dim=-1)
        o = _mm(pw.to(cv.dtype), cv.permute(0, 2, 1, 3)).to(x.dtype)
    y = dense(p["o"], o.reshape(b, 1, h * hd), f"{name}.o")
    return y, cache
