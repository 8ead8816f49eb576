"""Decoder-only LM assembly: attention + dense-MLP layers (opt-proxy,
internlm2, minicpm, stablelm, pixtral; windowed attention on a ring cache
for h2o-danube) and Mamba-1 layers (falcon-mamba).

``layer_specs(cfg)`` expands the block pattern into one ``(mixer, mlp)``
spec per layer, as the JAX package does: ``("attn", "dense")``,
``("swa", "dense")`` / ``("local", "dense")`` (attention over the last
``window_size`` positions) or ``("mamba", "none")``; every per-layer
function branches on it.

Param layout: ``{"embed": {...}, "layers": [layer, ...], "final_norm":
{...}, "lm_head": {...}}`` — a plain per-layer list where the JAX package
stacks layers along a scan axis (``convert.params_from_numpy`` unstacks);
a model with tied embeddings has no ``lm_head``. ``forward`` and
``prefill`` take optional frontend ``embeds`` (B, F, D), prepended to the
token embeddings in the compute dtype (pixtral's patch embeddings), so the
text starts at position F.
An attention layer is ``{"norm1", "mixer": {q, k, v, o}, "norm2", "mlp":
{up, down (, gate)}}``; a Mamba layer is ``{"norm1", "mixer": {in, conv,
x, dt, a_log, d_skip, out}}`` with no ``norm2`` and no ``mlp``. Dense
weights are stored (in, out).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import (embed, init_embed, init_mlp,
                                       init_norm, mlp, norm, unembed)
from repro_torch.models.linear import init_dense

Tensor = torch.Tensor
LayerSpec = Tuple[str, str]     # (mixer, mlp)
CacheDtype = Union[torch.dtype, str]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _window_of(cfg: ModelConfig, mixer: str) -> int:
    return cfg.window_size if mixer in ("swa", "local") else 0


def layer_specs(cfg: ModelConfig) -> Tuple[LayerSpec, ...]:
    return tuple(("mamba", "none") if kind == "mamba" else (kind, "dense")
                 for kind in cfg.layer_kinds)


def init_layer(cfg: ModelConfig, spec: LayerSpec, gen: torch.Generator,
               device) -> Dict:
    mixer, mlp_kind = spec
    bias = cfg.norm == "layernorm"
    p = {"norm1": init_norm(cfg, cfg.d_model, device)}
    if mixer == "mamba":
        p["mixer"] = rec.init_mamba_block(cfg, gen, device)
    else:
        p["mixer"] = attn.init_attention(cfg, gen, bias, device)
    if mlp_kind != "none":
        p["norm2"] = init_norm(cfg, cfg.d_model, device)
        p["mlp"] = init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, bias, device)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Dict:
    """Random weights with the JAX package's shapes and scales, drawn from
    ``gen`` (which must live on ``device``); no ``lm_head`` when the
    embeddings are tied."""
    params = {
        "embed": init_embed(gen, cfg.vocab_size, cfg.d_model, device),
        "layers": [init_layer(cfg, spec, gen, device)
                   for spec in layer_specs(cfg)],
        "final_norm": init_norm(cfg, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(gen, cfg.d_model, cfg.vocab_size,
                                       device=device)
    return params


def _mlp_residual(cfg: ModelConfig, spec: LayerSpec, p: Dict, h: Tensor
                  ) -> Tensor:
    if spec[1] == "none":
        return h
    return h + mlp(cfg, p["mlp"], norm(cfg, p["norm2"], h), name="mlp")


def layer_forward(cfg: ModelConfig, spec: LayerSpec, p: Dict, h: Tensor,
                  positions: Tensor) -> Tensor:
    """One layer over a full sequence (no cache)."""
    hn = norm(cfg, p["norm1"], h)
    if spec[0] == "mamba":
        y, _ = rec.mamba_block(cfg, p["mixer"], hn, None, name="mixer")
    else:
        y = attn.attention_forward(cfg, p["mixer"], hn, positions,
                                   window=_window_of(cfg, spec[0]),
                                   name="mixer")
    return _mlp_residual(cfg, spec, p, h + y)


def positions_for(b: int, s: int, device) -> Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def embed_inputs(cfg: ModelConfig, params: Dict, tokens: Tensor,
                 embeds: Optional[Tensor] = None) -> Tensor:
    """Token embeddings in the compute dtype, with frontend ``embeds``
    (B, F, D) prepended when given."""
    dtype = compute_dtype(cfg)
    h = embed(params["embed"], tokens, dtype)
    if embeds is not None:
        h = torch.cat([embeds.to(device=h.device, dtype=dtype), h], dim=1)
    return h


def forward(cfg: ModelConfig, params: Dict, tokens: Tensor,
            embeds: Optional[Tensor] = None) -> Tensor:
    """Full-sequence forward → logits (B, F + S, V) f32 (F frontend
    positions first)."""
    h = embed_inputs(cfg, params, tokens, embeds)
    b, s, _ = h.shape
    positions = positions_for(b, s, h.device)
    for spec, p in zip(layer_specs(cfg), params["layers"]):
        h = layer_forward(cfg, spec, p, h, positions)
    return unembed(cfg, params, norm(cfg, params["final_norm"], h))


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, device,
                     dtype: CacheDtype = torch.bfloat16) -> Dict:
    """``dtype`` may be ``"int8"``: the quantized KV-cache layout
    (attention.init_kv_cache); a windowed layer's cache is a ring of
    ``min(window_size, max_len)`` slots; a Mamba layer's recurrent state
    stays in float and takes bf16 for it, as the JAX package's
    ``_float_cache_dtype`` does."""
    if spec[0] == "mamba":
        return rec.init_mamba_state(
            cfg, batch, device, torch.bfloat16 if dtype == "int8" else dtype)
    if _window_of(cfg, spec[0]) > 0:
        max_len = min(cfg.window_size, max_len)
    return attn.init_kv_cache(cfg, batch, max_len, device, dtype)


def prefill(cfg: ModelConfig, params: Dict, tokens: Tensor, max_len: int,
            cache_dtype: CacheDtype = torch.bfloat16,
            embeds: Optional[Tensor] = None) -> Tuple[Tensor, List[Dict]]:
    """Prefill the caches; returns (last-position logits (B, V), caches).
    ``cache_dtype`` is a torch dtype or ``"int8"``; ``embeds`` (B, F, D)
    are prepended to the prompt (positions [0, F))."""
    h = embed_inputs(cfg, params, tokens, embeds)
    b, s, _ = h.shape
    positions = positions_for(b, s, h.device)
    caches = []
    for spec, p in zip(layer_specs(cfg), params["layers"]):
        cache = init_layer_cache(cfg, spec, b, max_len, h.device,
                                 cache_dtype)
        hn = norm(cfg, p["norm1"], h)
        if spec[0] == "mamba":
            y, cache = rec.mamba_block(cfg, p["mixer"], hn, cache,
                                       name="mixer")
        else:
            y, cache = attn.attention_prefill(
                cfg, p["mixer"], hn, positions, cache,
                window=_window_of(cfg, spec[0]), name="mixer")
        h = _mlp_residual(cfg, spec, p, h + y)
        caches.append(cache)
    h = norm(cfg, params["final_norm"], h[:, -1:])
    return unembed(cfg, params, h)[:, 0], caches


def decode_step(cfg: ModelConfig, params: Dict, token: Tensor, pos: Tensor,
                caches: List[Dict]) -> Tuple[Tensor, List[Dict]]:
    """One decode step: token (B,) at positions pos (B,) → logits (B, V)
    and ``caches``, every layer's cache or state updated in place (a
    captured step replays on the same buffers)."""
    h = embed(params["embed"], token[:, None], compute_dtype(cfg))
    for spec, p, cache in zip(layer_specs(cfg), params["layers"], caches):
        hn = norm(cfg, p["norm1"], h)
        if spec[0] == "mamba":
            y, _ = rec.mamba_decode(cfg, p["mixer"], hn, cache, name="mixer")
        else:
            y, _ = attn.attention_decode(cfg, p["mixer"], hn, pos, cache,
                                         window=_window_of(cfg, spec[0]),
                                         name="mixer")
        h = _mlp_residual(cfg, spec, p, h + y)
    h = norm(cfg, params["final_norm"], h)
    return unembed(cfg, params, h)[:, 0], caches
