"""Decoder-only LM assembly (attention + dense-MLP layers: opt-proxy,
internlm2).

Param layout: ``{"embed": {...}, "layers": [layer, ...], "final_norm":
{...}, "lm_head": {...}}`` — a plain per-layer list where the JAX package
stacks layers along a scan axis (``convert.params_from_numpy`` unstacks).
A layer is ``{"norm1", "mixer": {q, k, v, o}, "norm2", "mlp": {up, down
(, gate)}}``; dense weights are stored (in, out).
"""
from __future__ import annotations

from typing import Dict, List, Tuple, Union

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed, init_embed, init_mlp,
                                       init_norm, mlp, norm, unembed)
from repro_torch.models.linear import init_dense

Tensor = torch.Tensor


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_layer(cfg: ModelConfig, gen: torch.Generator, device) -> Dict:
    bias = cfg.norm == "layernorm"
    return {"norm1": init_norm(cfg, cfg.d_model, device),
            "mixer": attn.init_attention(cfg, gen, bias, device),
            "norm2": init_norm(cfg, cfg.d_model, device),
            "mlp": init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, bias, device)}


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Dict:
    """Random weights with the JAX package's shapes and scales, drawn from
    ``gen`` (which must live on ``device``)."""
    return {
        "embed": init_embed(gen, cfg.vocab_size, cfg.d_model, device),
        "layers": [init_layer(cfg, gen, device)
                   for _ in range(cfg.num_layers)],
        "final_norm": init_norm(cfg, cfg.d_model, device),
        "lm_head": init_dense(gen, cfg.d_model, cfg.vocab_size,
                              device=device),
    }


def layer_forward(cfg: ModelConfig, p: Dict, h: Tensor, positions: Tensor
                  ) -> Tensor:
    """One layer over a full sequence (no cache)."""
    h = h + attn.attention_forward(cfg, p["mixer"], norm(cfg, p["norm1"], h),
                                   positions, name="mixer")
    return h + mlp(cfg, p["mlp"], norm(cfg, p["norm2"], h), name="mlp")


def positions_for(b: int, s: int, device) -> Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def forward(cfg: ModelConfig, params: Dict, tokens: Tensor) -> Tensor:
    """Full-sequence forward → logits (B, S, V) f32."""
    h = embed(params["embed"], tokens, compute_dtype(cfg))
    b, s, _ = h.shape
    positions = positions_for(b, s, h.device)
    for p in params["layers"]:
        h = layer_forward(cfg, p, h, positions)
    return unembed(cfg, params, norm(cfg, params["final_norm"], h))


def init_layer_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                     dtype: Union[torch.dtype, str] = torch.bfloat16) -> Dict:
    """``dtype`` may be ``"int8"``: the quantized cache layout
    (attention.init_kv_cache)."""
    return attn.init_kv_cache(cfg, batch, max_len, device, dtype)


def prefill(cfg: ModelConfig, params: Dict, tokens: Tensor, max_len: int,
            cache_dtype: Union[torch.dtype, str] = torch.bfloat16
            ) -> Tuple[Tensor, List[Dict]]:
    """Prefill the caches; returns (last-position logits (B, V), caches).
    ``cache_dtype`` is a torch dtype or ``"int8"``."""
    h = embed(params["embed"], tokens, compute_dtype(cfg))
    b, s, _ = h.shape
    positions = positions_for(b, s, h.device)
    caches = []
    for p in params["layers"]:
        cache = init_layer_cache(cfg, b, max_len, h.device, cache_dtype)
        y, cache = attn.attention_prefill(cfg, p["mixer"],
                                          norm(cfg, p["norm1"], h),
                                          positions, cache, name="mixer")
        h = h + y
        h = h + mlp(cfg, p["mlp"], norm(cfg, p["norm2"], h), name="mlp")
        caches.append(cache)
    h = norm(cfg, params["final_norm"], h[:, -1:])
    return unembed(cfg, params, h)[:, 0], caches


def decode_step(cfg: ModelConfig, params: Dict, token: Tensor, pos: Tensor,
                caches: List[Dict]) -> Tuple[Tensor, List[Dict]]:
    """One decode step: token (B,) at positions pos (B,) → logits (B, V).
    The caches are updated in place."""
    h = embed(params["embed"], token[:, None], compute_dtype(cfg))
    for p, cache in zip(params["layers"], caches):
        y, _ = attn.attention_decode(cfg, p["mixer"],
                                     norm(cfg, p["norm1"], h), pos, cache,
                                     name="mixer")
        h = h + y
        h = h + mlp(cfg, p["mlp"], norm(cfg, p["norm2"], h), name="mlp")
    h = norm(cfg, params["final_norm"], h)
    return unembed(cfg, params, h)[:, 0], caches
