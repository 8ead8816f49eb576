"""Model assembly: decoder-only LMs of attention + dense-MLP layers
(opt-proxy, internlm2, minicpm, stablelm, pixtral; windowed attention on a
ring cache for h2o-danube), attention + routed-MoE layers (olmoe), MLA +
dense / routed-MoE layers with an MTP head (deepseek), RG-LRU and local
attention layers (recurrentgemma), Mamba-1 layers (falcon-mamba), and the
encoder-decoder (whisper).

``layer_specs(cfg)`` expands the block pattern into one ``(mixer, mlp)``
spec per layer, as the JAX package does: ``("attn", "dense")``,
``("swa", "dense")`` / ``("local", "dense")`` (attention over the last
``window_size`` positions), ``("mla", ·)`` (an attention kind when
``mla.enabled``), ``("rglru", "dense")``, ``(·, "moe")`` (a config with
``moe.num_experts`` > 0, from layer ``moe.first_dense_layers`` on) or
``("mamba", "none")``; every per-layer function branches on it.

Param layout: ``{"embed": {...}, "layers": [layer, ...], "final_norm":
{...}, "lm_head": {...}}`` — a plain per-layer list where the JAX package
stacks layers along a scan axis (``convert.params_from_numpy`` unstacks);
a model with tied embeddings has no ``lm_head``; a config with
``mtp_depth`` > 0 adds ``"mtp": {"proj": (2d → d), "norm", "layer"}``, a
layer of the last layer's spec (:func:`mtp_logits`). ``forward`` and
``prefill`` take optional frontend ``embeds`` (B, F, D), prepended to the
token embeddings in the compute dtype (pixtral's patch embeddings), so the
text starts at position F.
An attention layer is ``{"norm1", "mixer": {q, k, v, o}, "norm2", "mlp":
{up, down (, gate)}}``; a routed-MoE layer's ``"mlp"`` is ``{router: {w},
w_gate, w_up: (E, d, f), w_down: (E, f, d) (, shared)}`` (models/moe.py); a
Mamba layer is ``{"norm1", "mixer": {in, conv,
x, dt, a_log, d_skip, out}}`` with no ``norm2`` and no ``mlp``; an MLA
mixer is ``{q_down, q_up, kv_down, k_rope, k_up, v_up, o}``, an RG-LRU
mixer ``{in, gate, conv, rg, ig, lambda, out}``. Dense weights are stored
(in, out).

Encoder-decoder layout (whisper), the JAX package's nesting with per-layer
lists where it stacks along a scan axis: ``{"encoder": {"layers":
[layer, ...], "final_norm"}, "decoder": {"layers": [{"layer": {norm1,
mixer, norm2, mlp}, "xnorm", "xattn": {q, k, v, o}}, ...], "final_norm"},
"embed", "lm_head"}``. The encoder is bidirectional over ``frames`` (B,
Se, D), precomputed conv-frontend outputs; encoder and decoder inputs add
fixed sinusoidal positions and no layer applies RoPE. A decoder layer's
cache is ``{"self": <a self-attention cache, bf16 or int8>, "cross":
{"k", "v"}}``: the encoder K/V, computed once at prefill and kept in
float (bf16 when the self-cache is int8, as the JAX package's
``_float_cache_dtype``).

Training (``forward_train``, ``encdec_forward``) returns the summed
routed-MoE load-balance losses beside the logits. ``segments(cfg)`` groups
the layers as the JAX package's ``segment_specs`` does: runs of a periodic
super-block or of one spec. With ``remat`` each super-block (one scan
step of the reference) runs under ``torch.utils.checkpoint``, the twin of
the reference's ``jax.checkpoint``: its activations are recomputed in the
backward, bitwise the forward's.

Under a sharded step's ``model`` split (``sharding.use_split``, the plan
of ``sharding.model_split``) the training forward runs on the rank's
blocks: attention (self and cross) on its heads, or a GQA self-attention
on its q-heads over its one kv-head, and the dense MLP on its ``d_ff``
columns, entered by ``ModelSplit.enter`` and left by the o / down
product's row-parallel sum; a Mamba mixer on its ``d_inner`` channels
and an RG-LRU mixer on its ``lru_width`` channels (each left by the out
product's sum); an MLA mixer on its heads over the whole latents; a
routed MLP on its experts (the routing whole on every rank); deepseek's
MTP projection on its output columns and the MTP layer by the main
layers' kinds; the embedding and the head on its vocab rows
(``layers.embed``; the logits stay vocab-parallel for
``train_step.cross_entropy``); a kind whose widths do not divide the
axis whole on every rank. Where the
plan's ``sp`` holds and a residual's sequence divides the axis, the
residual between layers is the rank's block of the sequence: norms run on
it, a product's input is gathered over the sequence and a row-parallel
output reduce-scattered (``ModelSplit.seq_split``; the encoder's and the
decoder's sequences each on their own).

The chunked prefill (``prefill_begin`` / ``prefill_step`` /
``prefill_finish``, ``prefill_chunked`` and the ``encdec_*`` twins) runs
a prompt some positions at a time: each chunk's attention reads the
history from the cache (attention.attention_prefill's and mla_prefill's
``start``), a Mamba or RG-LRU layer carries its state on, and a routed-MoE
layer dispatches the
chunk at the chunk's own expert capacity, as the JAX package does. The
slotted cache of the continuous engine (``cache_slots_like`` /
``cache_slot_insert`` / ``cache_slot_evict``) keeps every cache leaf's
lane axis first and is written in place.
"""
from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.utils.checkpoint

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import current_split, gather_seq
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import (embed, init_embed, init_mlp,
                                       init_norm, mlp, norm,
                                       sinusoidal_positions, unembed)
from repro_torch.models.linear import dense, init_dense

Tensor = torch.Tensor
LayerSpec = Tuple[str, str]     # (mixer, mlp)
CacheDtype = Union[torch.dtype, str]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _window_of(cfg: ModelConfig, mixer: str) -> int:
    return cfg.window_size if mixer in ("swa", "local") else 0


def layer_specs(cfg: ModelConfig) -> Tuple[LayerSpec, ...]:
    def spec(i: int, kind: str) -> LayerSpec:
        if kind == "mamba":
            return ("mamba", "none")
        mixer = "mla" if cfg.mla.enabled and kind != "rglru" else kind
        routed = (cfg.moe.num_experts > 0
                  and i >= cfg.moe.first_dense_layers)
        return (mixer, "moe" if routed else "dense")
    return tuple(spec(i, kind) for i, kind in enumerate(cfg.layer_kinds))


class Segment(NamedTuple):
    specs: Tuple[LayerSpec, ...]    # the super-block's period
    count: int                      # its repeats


def segment_specs(specs: Sequence[LayerSpec],
                  pattern_len: int) -> List[Segment]:
    """The JAX package's greedy tiling: periodic super-blocks of
    ``pattern_len`` where they repeat longer than a run of one spec, runs
    of one spec elsewhere."""
    segs: List[Segment] = []
    i, n = 0, len(specs)
    while i < n:
        j = i
        while j < n and specs[j] == specs[i]:
            j += 1
        run1, runq, q = j - i, 0, pattern_len
        if q > 1 and i + q <= n:
            base = tuple(specs[i:i + q])
            while (i + (runq + 1) * q <= n
                   and tuple(specs[i + runq * q:i + (runq + 1) * q]) == base):
                runq += 1
        if q > 1 and runq * q > run1:
            segs.append(Segment(tuple(specs[i:i + q]), runq))
            i += runq * q
        else:
            segs.append(Segment((specs[i],), run1))
            i += run1
    return segs


def segments(cfg: ModelConfig) -> List[Segment]:
    """The layer stack as the reference's scanned segments (its ``blocks``
    list; ``convert.stack_layers`` stacks the port's layers so)."""
    return segment_specs(layer_specs(cfg), len(cfg.block_pattern))


def init_layer(cfg: ModelConfig, spec: LayerSpec, gen: torch.Generator,
               device) -> Dict:
    mixer, mlp_kind = spec
    bias = cfg.norm == "layernorm"
    p = {"norm1": init_norm(cfg, cfg.d_model, device)}
    if mixer == "mamba":
        p["mixer"] = rec.init_mamba_block(cfg, gen, device)
    elif mixer == "rglru":
        p["mixer"] = rec.init_rglru_block(cfg, gen, device)
    elif mixer == "mla":
        p["mixer"] = attn.init_mla(cfg, gen, device)
    else:
        p["mixer"] = attn.init_attention(cfg, gen, bias, device)
    if mlp_kind != "none":
        p["norm2"] = init_norm(cfg, cfg.d_model, device)
        p["mlp"] = (moe_mod.init_moe(cfg, gen, device) if mlp_kind == "moe"
                    else init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, bias,
                                  device))
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
    if cfg.mtp_depth > 0:
        params["mtp"] = {
            "proj": init_dense(gen, 2 * cfg.d_model, cfg.d_model,
                               device=device),
            "norm": init_norm(cfg, cfg.d_model, device),
            "layer": init_layer(cfg, layer_specs(cfg)[-1], gen, device)}
    return params


# -- the training forward's pieces under a model split (module docstring):
# without a split each is the one-device function itself

def _norm_of(cfg: ModelConfig, p: Dict, h: Tensor, seq: bool) -> Tensor:
    """The norm of ``h``; where ``h`` is this rank's block of the
    sequence its weights' gradients are summed over the axis."""
    split = current_split()
    return norm(cfg, p if split is None else split.partial(p, seq), h)


def _whole(fn, hn: Tensor, seq: bool):
    """``fn(hn)`` computed whole on every rank of the axis (a product the
    split does not cover), ``hn`` and the output the residual's."""
    split = current_split()
    if split is None:
        return fn(hn)
    return split.leave(fn(split.enter(hn, False, seq)), seq)


def _self_attention(cfg: ModelConfig, p: Dict, hn: Tensor,
                    positions: Tensor, seq: bool, **kw) -> Tensor:
    """A layer's self-attention of its normed input; split by heads where
    the plan splits attention, by q-heads over the rank's one kv-head
    where it splits GQA (``ModelSplit.kv_share``)."""
    split = current_split()
    if split is None or not (split.attn or split.gqa):
        return _whole(lambda x: attn.attention_forward(cfg, p, x, positions,
                                                       **kw), hn, seq)
    if split.gqa:
        p = split.kv_share(p)
    return attn.attention_forward(
        split.cfg, split.row_params(p, seq), split.enter(hn, True, seq),
        positions, reduce=split.row_reduce(seq), **kw)


def _dense_mlp(cfg: ModelConfig, p: Dict, hn: Tensor, seq: bool,
               name: str) -> Tensor:
    """A dense MLP of the normed input; split by ``d_ff`` where the plan
    splits it."""
    split = current_split()
    if split is None or not split.mlp:
        return _whole(lambda x: mlp(cfg, p, x, name=name), hn, seq)
    return mlp(split.cfg, split.row_params(p, seq), split.enter(hn, True, seq),
               name=name, reduce=split.row_reduce(seq))


def _mamba(cfg: ModelConfig, p: Dict, hn: Tensor, seq: bool,
           name: str) -> Tensor:
    """A Mamba mixer of the normed input; split by its ``d_inner``
    channels where the plan splits Mamba: the in product column-parallel
    (``ModelSplit.mamba_params``), the conv, the scan and the x / dt
    products on the rank's channels, the x projection summed over the
    axis forward and backward, the out product row-parallel."""
    split = current_split()
    if split is None or not split.mamba:
        return _whole(lambda x: rec.mamba_block(cfg, p, x, None,
                                                name=name)[0], hn, seq)
    return rec.mamba_block(split.cfg, split.mamba_params(p),
                           split.enter(hn, True, seq), None, name=name,
                           reduce=split.row_reduce(seq),
                           x_reduce=split.all_reduce)[0]


def _rglru(cfg: ModelConfig, p: Dict, hn: Tensor, seq: bool,
           name: str) -> Tensor:
    """An RG-LRU mixer of the normed input; split by its ``lru_width``
    channels where the plan splits RG-LRU: in and gate column-parallel,
    the conv, ``lambda`` and the recurrence on the rank's channels, u
    all-gathered over the axis for rg / ig (``ModelSplit.
    gather_channels``: their input is every channel, their output the
    rank's), the out product row-parallel."""
    split = current_split()
    if split is None or not split.rglru:
        return _whole(lambda x: rec.rglru_block(cfg, p, x, None,
                                                name=name)[0], hn, seq)
    return rec.rglru_block(split.cfg, p, split.enter(hn, True, seq), None,
                           name=name, reduce=split.row_reduce(seq),
                           gather=split.gather_channels)[0]


def _mla(cfg: ModelConfig, p: Dict, hn: Tensor, positions: Tensor,
         seq: bool, name: str) -> Tensor:
    """An MLA mixer of the normed input; split by heads where the plan
    splits MLA: the latents (q_down, kv_down, k_rope) whole on every
    rank, x entering without a copy and the latents through one
    (``attention._mla_qkv``: a copy on x as well would count their
    gradient twice), q_up / k_up / v_up and the attention at the rank's
    heads, o row-parallel."""
    split = current_split()
    if split is None or not split.mla:
        return _whole(lambda x: attn.mla_forward(cfg, p, x, positions,
                                                 name=name), hn, seq)
    return attn.mla_forward(split.cfg, split.row_params(p, seq),
                            split.enter(hn, False, seq), positions,
                            name=name, split=split,
                            reduce=split.row_reduce(seq))


def _routed(cfg: ModelConfig, p: Dict, hn: Tensor, seq: bool, name: str
            ) -> Tuple[Tensor, Tensor]:
    """A routed MLP of the normed input and its load-balance loss; split
    by experts where the plan splits them (``moe.moe_ffn``'s ``split``:
    the routing whole on every rank, the rank's experts' products, their
    fp32 partials summed over the axis or reduce-scattered over the
    sequence)."""
    split = current_split()
    if split is None:
        out = moe_mod.moe_ffn(cfg, p, hn, name=name)
        return out.y, out.aux_loss
    x = split.enter(hn, False, seq)
    if not split.experts:
        out = moe_mod.moe_ffn(cfg, p, x, name=name)
        return split.leave(out.y, seq), out.aux_loss
    out = moe_mod.moe_ffn(cfg, p, x, name=name, split=split,
                          reduce=split.row_reduce(seq))
    return out.y, out.aux_loss


def _head(cfg: ModelConfig, params: Dict, h: Tensor, seq: bool) -> Tensor:
    """The logits of the final-normed ``h``: vocab-parallel (the rank's
    vocab block) where the plan splits the vocab."""
    split = current_split()
    if split is not None:
        h = split.enter(h, split.vocab, seq)
    return unembed(cfg, params, h)


def _mlp_residual(cfg: ModelConfig, spec: LayerSpec, p: Dict, h: Tensor,
                  name: str = "") -> Tensor:
    return _mlp_residual_aux(cfg, spec, p, h, name)[0]


def _mlp_residual_aux(cfg: ModelConfig, spec: LayerSpec, p: Dict, h: Tensor,
                      name: str = "", seq: bool = False
                      ) -> Tuple[Tensor, Optional[Tensor]]:
    """h plus the layer's MLP, and a routed MLP's load-balance loss (None
    for a dense MLP or none)."""
    if spec[1] == "none":
        return h, None
    hn = _norm_of(cfg, p["norm2"], h, seq)
    if spec[1] == "moe":
        y, aux = _routed(cfg, p["mlp"], hn, seq, f"{name}mlp")
        return h + y, aux
    return h + _dense_mlp(cfg, p["mlp"], hn, seq, f"{name}mlp"), None


def layer_forward(cfg: ModelConfig, spec: LayerSpec, p: Dict, h: Tensor,
                  positions: Tensor, name: str = "") -> Tensor:
    """One layer over a full sequence (no cache); its linears are tapped
    as ``{name}mixer.*`` / ``{name}mlp.*``."""
    return layer_forward_aux(cfg, spec, p, h, positions, name)[0]


def layer_forward_aux(cfg: ModelConfig, spec: LayerSpec, p: Dict, h: Tensor,
                      positions: Tensor, name: str = "", seq: bool = False
                      ) -> Tuple[Tensor, Optional[Tensor]]:
    """:func:`layer_forward` and the layer's load-balance loss (None but
    for a routed MLP), the JAX package's train-mode ``layer_forward``.
    ``seq``: ``h`` is this rank's block of the sequence (a model split's
    ``sp``; ``positions`` are the whole sequence's)."""
    hn = _norm_of(cfg, p["norm1"], h, seq)
    mixer = f"{name}mixer"
    if spec[0] == "mamba":
        y = _mamba(cfg, p["mixer"], hn, seq, mixer)
    elif spec[0] == "rglru":
        y = _rglru(cfg, p["mixer"], hn, seq, mixer)
    elif spec[0] == "mla":
        y = _mla(cfg, p["mixer"], hn, positions, seq, mixer)
    else:
        y = _self_attention(cfg, p["mixer"], hn, positions, seq,
                            window=_window_of(cfg, spec[0]), name=mixer)
    return _mlp_residual_aux(cfg, spec, p, h + y, name, seq)


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
    return forward_hidden(cfg, params, tokens, embeds)[0]


def forward_hidden(cfg: ModelConfig, params: Dict, tokens: Tensor,
                   embeds: Optional[Tensor] = None
                   ) -> Tuple[Tensor, Tensor]:
    """:func:`forward` that also returns the final-normed hidden states
    (B, F + S, D), the input of the MTP head (:func:`mtp_logits`)."""
    logits, _, h = forward_train(cfg, params, tokens, embeds,
                                 return_hidden=True)
    return logits, h


def _superblock(cfg: ModelConfig, specs: Sequence[LayerSpec],
                layers: Sequence[Dict], h: Tensor, aux: Tensor,
                positions: Tensor, seq: bool = False
                ) -> Tuple[Tensor, Tensor]:
    """One scan step of a segment: its layers in order, the routed
    layers' load-balance losses added to ``aux`` in layer order."""
    for spec, p in zip(specs, layers):
        h, a = layer_forward_aux(cfg, spec, p, h, positions, seq=seq)
        if a is not None:
            aux = aux + a
    return h, aux


def forward_train(cfg: ModelConfig, params: Dict, tokens: Tensor,
                  embeds: Optional[Tensor] = None, *, remat: bool = False,
                  return_hidden: bool = False):
    """The training forward, the JAX package's ``forward``: (logits (B, F
    + S, V) f32, the summed load-balance loss (a f32 scalar, 0 for a model
    without routed layers)) or, with ``return_hidden``, also the
    final-normed hidden states (the MTP head's input). The layers run
    super-block by super-block of :func:`segments`; with ``remat`` each
    super-block is recomputed in the backward (its activations are not
    kept). Under a model split with ``sp`` the returned hidden states are
    this rank's block of the sequence, where it divides the axis."""
    h = embed_inputs(cfg, params, tokens, embeds)
    b, s, _ = h.shape
    positions = positions_for(b, s, h.device)
    split = current_split()
    seq = split is not None and split.seq_split(s)
    if seq:
        h = split.leave(h, True)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    layers = params["layers"]
    li = 0
    for seg in segments(cfg):
        n = len(seg.specs)
        for _ in range(seg.count):
            group = layers[li:li + n]
            li += n
            if remat:
                h, aux = torch.utils.checkpoint.checkpoint(
                    _superblock, cfg, seg.specs, group, h, aux, positions,
                    seq, use_reentrant=False)
            else:
                h, aux = _superblock(cfg, seg.specs, group, h, aux,
                                     positions, seq)
    h = _norm_of(cfg, params["final_norm"], h, seq)
    logits = _head(cfg, params, h, seq)
    return (logits, aux, h) if return_hidden else (logits, aux)


def mtp_logits(cfg: ModelConfig, params: Dict, h_final: Tensor,
               tokens: Tensor) -> Tensor:
    """deepseek's multi-token prediction head: position t predicts token
    t + 2 from (h_t, e_{t+1}). h_final (B, S, D) the final-normed hidden
    states, tokens (B, S) → logits (B, S - 1, V) f32. Training reads it
    (the JAX package's train step); serving does not.

    Under a model split the MTP layer runs under the plan, as the main
    layers do, on its whole S − 1 positions; the projection is
    column-parallel where the plan's ``mtp`` holds: its input enters
    ``copy_to_model``, the rank computes its d/m columns of h0 and they
    are all-gathered (``ModelSplit.gather_channels``, a cut backward: the
    residual's gradient is whole on every rank). Under ``sp`` h_final is
    this rank's block of the sequence (``forward_train``) and is gathered
    first; the embedding and the head may be vocab-parallel."""
    p = params["mtp"]
    split = current_split()
    if split is not None and split.seq_split(tokens.shape[1]):
        h_final = gather_seq(h_final, split.ag, summed=False)
    e_next = embed(params["embed"], tokens[:, 1:], h_final.dtype)
    x = torch.cat([h_final[:, :-1], e_next], dim=-1)
    if split is not None and split.mtp:
        h0 = split.gather_channels(
            dense(p["proj"], split.enter(x, True, False), "mtp.proj"),
            summed=False)
    else:
        h0 = dense(p["proj"], x, "mtp.proj")
    b, s, _ = h0.shape
    h1 = layer_forward(cfg, layer_specs(cfg)[-1], p["layer"], h0,
                       positions_for(b, s, h0.device), name="mtp.")
    return _head(cfg, params, norm(cfg, p["norm"], h1), False)


def _float_cache_dtype(dtype: CacheDtype) -> torch.dtype:
    """A cache that stays in float (an MLA latent cache, a recurrent
    state, an enc-dec cross cache) takes bf16 where the attention caches
    are int8."""
    return torch.bfloat16 if dtype == "int8" else dtype


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, device,
                     dtype: CacheDtype = torch.bfloat16) -> Dict:
    """``dtype`` may be ``"int8"``: the quantized KV-cache layout
    (attention.init_kv_cache); a windowed layer's cache is a ring of
    ``min(window_size, max_len)`` slots; an MLA latent cache and a Mamba
    or RG-LRU layer's recurrent state stay in float and take bf16 for it,
    as the JAX package's ``_float_cache_dtype`` does."""
    if spec[0] == "mamba":
        return rec.init_mamba_state(cfg, batch, device,
                                    _float_cache_dtype(dtype))
    if spec[0] == "rglru":
        return rec.init_rglru_state(cfg, batch, device,
                                    _float_cache_dtype(dtype))
    if spec[0] == "mla":
        return attn.init_mla_cache(cfg, batch, max_len, device,
                                   _float_cache_dtype(dtype))
    if _window_of(cfg, spec[0]) > 0:
        max_len = min(cfg.window_size, max_len)
    return attn.init_kv_cache(cfg, batch, max_len, device, dtype)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device,
                dtype: CacheDtype = torch.bfloat16) -> List[Dict]:
    """Every layer's empty cache or state (:func:`init_layer_cache`)."""
    return [init_layer_cache(cfg, spec, batch, max_len, device, dtype)
            for spec in layer_specs(cfg)]


def layer_prefill(cfg: ModelConfig, spec: LayerSpec, p: Dict, h: Tensor,
                  positions: Tensor, cache: Dict,
                  start: Optional[int] = None) -> Tuple[Tensor, Dict]:
    """One layer over prompt positions, writing its cache (``start``: the
    chunked prefill's continuation, attention.attention_prefill and
    mla_prefill); a Mamba or RG-LRU layer carries its state on from
    ``cache`` and returns a new one."""
    hn = norm(cfg, p["norm1"], h)
    if spec[0] == "mamba":
        y, cache = rec.mamba_block(cfg, p["mixer"], hn, cache, name="mixer")
    elif spec[0] == "rglru":
        y, cache = rec.rglru_block(cfg, p["mixer"], hn, cache, name="mixer")
    elif spec[0] == "mla":
        y, cache = attn.mla_prefill(cfg, p["mixer"], hn, positions, cache,
                                    name="mixer", start=start)
    else:
        y, cache = attn.attention_prefill(
            cfg, p["mixer"], hn, positions, cache,
            window=_window_of(cfg, spec[0]), name="mixer", start=start)
    return _mlp_residual(cfg, spec, p, h + y), cache


def _positions_from(start: int, b: int, s: int, device) -> Tensor:
    return (start + torch.arange(s, device=device))[None, :].expand(b, s)


def prefill(cfg: ModelConfig, params: Dict, tokens: Tensor, max_len: int,
            cache_dtype: CacheDtype = torch.bfloat16,
            embeds: Optional[Tensor] = None) -> Tuple[Tensor, List[Dict]]:
    """Prefill the caches; returns (last-position logits (B, V), caches).
    ``cache_dtype`` is a torch dtype or ``"int8"``; ``embeds`` (B, F, D)
    are prepended to the prompt (positions [0, F))."""
    h, caches = prefill_begin(cfg, params, tokens, max_len, cache_dtype,
                              embeds)
    b, s, _ = h.shape
    positions = positions_for(b, s, h.device)
    for i, (spec, p) in enumerate(zip(layer_specs(cfg), params["layers"])):
        h, caches[i] = layer_prefill(cfg, spec, p, h, positions, caches[i])
    return prefill_finish(cfg, params, h), caches


def prefill_begin(cfg: ModelConfig, params: Dict, tokens: Tensor,
                  max_len: int, cache_dtype: CacheDtype = torch.bfloat16,
                  embeds: Optional[Tensor] = None
                  ) -> Tuple[Tensor, List[Dict]]:
    """The incremental prefill's start: the embedded inputs ``h`` (B, F +
    S, D) and empty caches of ``max_len``; slices of ``h`` go through
    :func:`prefill_step` one chunk at a time."""
    h = embed_inputs(cfg, params, tokens, embeds)
    return h, init_caches(cfg, h.shape[0], max_len, h.device, cache_dtype)


def prefill_step(cfg: ModelConfig, params: Dict, h_chunk: Tensor,
                 start: int, caches: List[Dict]
                 ) -> Tuple[Tensor, List[Dict]]:
    """One prefill chunk at positions [start, start + C): each attention
    layer attends to its cached history and the chunk, each Mamba or
    RG-LRU layer carries its state on, and a routed-MoE layer dispatches
    the chunk's tokens at the chunk's own expert capacity. Returns the
    chunk's block output and ``caches`` (attention and latent caches
    written in place, recurrent states replaced)."""
    b, c, _ = h_chunk.shape
    positions = _positions_from(start, b, c, h_chunk.device)
    h = h_chunk
    for i, (spec, p) in enumerate(zip(layer_specs(cfg), params["layers"])):
        h, caches[i] = layer_prefill(cfg, spec, p, h, positions, caches[i],
                                     start=start)
    return h, caches


def prefill_finish(cfg: ModelConfig, params: Dict, h_last: Tensor
                   ) -> Tensor:
    """Next-token logits (B, V) from the last chunk's block output."""
    h = norm(cfg, params["final_norm"], h_last[:, -1:])
    return unembed(cfg, params, h)[:, 0]


def prefill_chunked(cfg: ModelConfig, params: Dict, tokens: Tensor,
                    max_len: int, chunk: int,
                    cache_dtype: CacheDtype = torch.bfloat16,
                    embeds: Optional[Tensor] = None
                    ) -> Tuple[Tensor, List[Dict]]:
    """The prefill ``chunk`` positions at a time (``serve.prefill_chunk``),
    each chunk attending to the cached history and itself; the logits and
    caches are the single-shot :func:`prefill`'s up to rounding."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    h, caches = prefill_begin(cfg, params, tokens, max_len, cache_dtype,
                              embeds)
    s = h.shape[1]
    for c0 in range(0, s, chunk):
        hc, caches = prefill_step(cfg, params, h[:, c0:c0 + chunk], c0,
                                  caches)
    return prefill_finish(cfg, params, hc), caches


def decode_step(cfg: ModelConfig, params: Dict, token: Tensor, pos: Tensor,
                caches: List[Dict]) -> Tuple[Tensor, List[Dict]]:
    """One decode step: token (B,) at positions pos (B,) → logits (B, V)
    and ``caches``, every layer's cache or state updated in place (a
    captured step replays on the same buffers)."""
    h = embed(params["embed"], token[:, None], compute_dtype(cfg))
    for spec, p, cache in zip(layer_specs(cfg), params["layers"], caches):
        h = layer_decode(cfg, spec, p, h, pos, cache)
    h = norm(cfg, params["final_norm"], h)
    return unembed(cfg, params, h)[:, 0], caches


def layer_decode(cfg: ModelConfig, spec: LayerSpec, p: Dict, h: Tensor,
                 pos: Tensor, cache: Dict) -> Tensor:
    """One layer's decode step at positions pos (B,), its cache or state
    written in place."""
    hn = norm(cfg, p["norm1"], h)
    if spec[0] == "mamba":
        y, _ = rec.mamba_decode(cfg, p["mixer"], hn, cache, name="mixer")
    elif spec[0] == "rglru":
        y, _ = rec.rglru_decode(cfg, p["mixer"], hn, cache, name="mixer")
    elif spec[0] == "mla":
        y, _ = attn.mla_decode(cfg, p["mixer"], hn, pos, cache, name="mixer")
    else:
        y, _ = attn.attention_decode(cfg, p["mixer"], hn, pos, cache,
                                     window=_window_of(cfg, spec[0]),
                                     name="mixer")
    return _mlp_residual(cfg, spec, p, h + y)


# ---------------------------------------------------------------------------
# the slotted cache of the continuous engine (serving/scheduler.py)
# ---------------------------------------------------------------------------

def cache_leaves(caches):
    """Every tensor of a cache tree, in its order (dicts of tensors in
    per-layer lists: KV codes, scales and error accumulators, a Mamba
    state, an enc-dec layer's self and cross caches)."""
    if isinstance(caches, dict):
        for v in caches.values():
            yield from cache_leaves(v)
    elif isinstance(caches, (list, tuple)):
        for v in caches:
            yield from cache_leaves(v)
    else:
        yield caches


def _map_cache(fn, caches):
    if isinstance(caches, dict):
        return {k: _map_cache(fn, v) for k, v in caches.items()}
    if isinstance(caches, (list, tuple)):
        return [_map_cache(fn, v) for v in caches]
    return fn(caches)


def cache_slots_like(caches: List[Dict], lanes: int) -> List[Dict]:
    """A zeroed slotted decode cache of ``lanes`` lanes shaped like a
    batch-1 prefill cache: every leaf keeps the batch (lane) axis first."""
    return _map_cache(lambda a: torch.zeros((lanes,) + tuple(a.shape[1:]),
                                            dtype=a.dtype, device=a.device),
                      caches)


def cache_slot_insert(caches: List[Dict], src: List[Dict], lane: int
                      ) -> List[Dict]:
    """Write the batch-1 cache ``src`` into lane ``lane`` of the slotted
    ``caches``, every leaf in place (a captured decode step keeps reading
    the same tensors). The whole lane is overwritten, so a lane freed by
    an eviction needs no zeroing before it is reused."""
    for big, small in zip(cache_leaves(caches), cache_leaves(src)):
        big[lane].copy_(small[0])
    return caches


def cache_slot_evict(caches: List[Dict], lane: int) -> List[Dict]:
    """Zero lane ``lane`` in place (hygiene only: an insert overwrites the
    whole lane)."""
    for leaf in cache_leaves(caches):
        leaf[lane].zero_()
    return caches


# ---------------------------------------------------------------------------
# encoder-decoder (whisper)
# ---------------------------------------------------------------------------

def init_encdec_params(cfg: ModelConfig, gen: torch.Generator, device
                       ) -> Dict:
    """Random weights of the encoder-decoder with the JAX package's
    shapes and scales, drawn from ``gen`` (which must live on
    ``device``)."""
    spec = ("attn", "dense")
    return {
        "encoder": {"layers": [init_layer(cfg, spec, gen, device)
                               for _ in range(cfg.encoder_layers)],
                    "final_norm": init_norm(cfg, cfg.d_model, device)},
        "decoder": {"layers": [
            {"layer": init_layer(cfg, spec, gen, device),
             "xnorm": init_norm(cfg, cfg.d_model, device),
             "xattn": attn.init_cross_attention(cfg, gen, device)}
            for _ in range(cfg.num_layers)],
            "final_norm": init_norm(cfg, cfg.d_model, device)},
        "embed": init_embed(gen, cfg.vocab_size, cfg.d_model, device),
        "lm_head": init_dense(gen, cfg.d_model, cfg.vocab_size,
                              device=device),
    }


def with_positions(cfg: ModelConfig, h: Tensor) -> Tensor:
    """h (B, S, D) in the compute dtype plus the sinusoidal table of its
    S positions, cast to that dtype."""
    table = sinusoidal_positions(h.shape[1], cfg.d_model, h.device)
    return h + table.to(h.dtype)[None]


def encoder_layer(cfg: ModelConfig, p: Dict, h: Tensor, positions: Tensor,
                  seq: bool = False) -> Tensor:
    """One bidirectional encoder layer (no RoPE); ``seq`` as
    :func:`layer_forward_aux`'s."""
    hn = _norm_of(cfg, p["norm1"], h, seq)
    h = h + _self_attention(cfg, p["mixer"], hn, positions, seq,
                            causal=False, use_rope=False, name="mixer")
    return h + _dense_mlp(cfg, p["mlp"], _norm_of(cfg, p["norm2"], h, seq),
                          seq, "mlp")


def encode(cfg: ModelConfig, params: Dict, frames: Tensor) -> Tensor:
    """frames (B, Se, D), the conv frontend's outputs (a stub: they are
    given) → the encoder's final-normed states (B, Se, D) in the compute
    dtype (whole on every rank under a model split, also where the
    encoder ran sequence-sharded)."""
    h = with_positions(cfg, frames.to(compute_dtype(cfg)))
    positions = positions_for(h.shape[0], h.shape[1], h.device)
    split = current_split()
    seq = split is not None and split.seq_split(h.shape[1])
    if seq:
        h = split.leave(h, True)
    for p in params["encoder"]["layers"]:
        h = encoder_layer(cfg, p, h, positions, seq)
    h = _norm_of(cfg, params["encoder"]["final_norm"], h, seq)
    return split.enter(h, False, True) if seq else h


def decoder_inputs(cfg: ModelConfig, params: Dict, tokens: Tensor
                   ) -> Tensor:
    """Token embeddings plus their sinusoidal positions [0, S)."""
    return with_positions(cfg, embed(params["embed"], tokens,
                                     compute_dtype(cfg)))


def _cross_residual(cfg: ModelConfig, p: Dict, h: Tensor, kv: Dict
                    ) -> Tensor:
    """h plus the cross-attention to ``kv``, then the MLP residual."""
    h = h + attn.cross_attention(cfg, p["xattn"], norm(cfg, p["xnorm"], h),
                                 kv, "xattn")
    lp = p["layer"]
    return h + mlp(cfg, lp["mlp"], norm(cfg, lp["norm2"], h),
                   name="layer.mlp")


def _cross_attention(cfg: ModelConfig, p: Dict, h: Tensor, enc: Tensor,
                     seq: bool) -> Tensor:
    """The cross-attention of the decoder's ``h`` (its ``xnorm`` here) to
    the whole encoder states ``enc``, its K/V computed here; split by
    heads where the plan splits attention."""
    split = current_split()
    if split is None or not split.attn:
        kv = attn.cross_attention_kv(cfg, p["xattn"], enc, "xattn")
        return _whole(lambda x: attn.cross_attention(cfg, p["xattn"], x, kv,
                                                     "xattn"),
                      _norm_of(cfg, p["xnorm"], h, seq), seq)
    kv = attn.cross_attention_kv(split.cfg, p["xattn"],
                                 split.enter(enc, True, False), "xattn")
    hn = _norm_of(cfg, p["xnorm"], h, seq)
    return attn.cross_attention(split.cfg, split.row_params(p["xattn"], seq),
                                split.enter(hn, True, seq), kv, "xattn",
                                reduce=split.row_reduce(seq))


def decoder_layer(cfg: ModelConfig, p: Dict, h: Tensor, positions: Tensor,
                  enc: Tensor, seq: bool = False) -> Tensor:
    """One decoder layer over a full sequence: causal self-attention, the
    cross-attention to the encoder states ``enc`` (its K/V computed
    here), the MLP; ``seq`` as :func:`layer_forward_aux`'s."""
    lp = p["layer"]
    hn = _norm_of(cfg, lp["norm1"], h, seq)
    h = h + _self_attention(cfg, lp["mixer"], hn, positions, seq,
                            use_rope=False, name="layer.mixer")
    h = h + _cross_attention(cfg, p, h, enc, seq)
    return h + _dense_mlp(cfg, lp["mlp"], _norm_of(cfg, lp["norm2"], h, seq),
                          seq, "layer.mlp")


def encdec_forward(cfg: ModelConfig, params: Dict, frames: Tensor,
                   tokens: Tensor) -> Tuple[Tensor, Tensor]:
    """Teacher-forced forward → (logits (B, S, V) f32, the aux loss: a
    zero f32 scalar, which training adds as the JAX package's does)."""
    enc = encode(cfg, params, frames)
    h = decoder_inputs(cfg, params, tokens)
    positions = positions_for(h.shape[0], h.shape[1], h.device)
    split = current_split()
    seq = split is not None and split.seq_split(h.shape[1])
    if seq:
        h = split.leave(h, True)
    for p in params["decoder"]["layers"]:
        h = decoder_layer(cfg, p, h, positions, enc, seq)
    logits = _head(cfg, params,
                   _norm_of(cfg, params["decoder"]["final_norm"], h, seq),
                   seq)
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


def encdec_prefill(cfg: ModelConfig, params: Dict, frames: Tensor,
                   tokens: Tensor, max_len: int,
                   cache_dtype: CacheDtype = torch.bfloat16
                   ) -> Tuple[Tensor, List[Dict]]:
    """The encoder pass and the decoder prefill: returns (last-position
    logits (B, V), caches), each decoder layer's ``{"self", "cross"}``
    (module docstring); the self-caches hold ``max_len`` slots in
    ``cache_dtype`` (a torch dtype or ``"int8"``)."""
    enc = encode(cfg, params, frames)
    h = decoder_inputs(cfg, params, tokens)
    b, s, _ = h.shape
    positions = positions_for(b, s, h.device)
    cross_dtype = _float_cache_dtype(cache_dtype)
    caches = []
    for p in params["decoder"]["layers"]:
        lp = p["layer"]
        cache = attn.init_kv_cache(cfg, b, max_len, h.device, cache_dtype)
        y, cache = attn.attention_prefill(cfg, lp["mixer"],
                                          norm(cfg, lp["norm1"], h),
                                          positions, cache,
                                          name="layer.mixer")
        kv = attn.cross_attention_kv(cfg, p["xattn"], enc, "xattn")
        h = _cross_residual(cfg, p, h + y, kv)
        caches.append({"self": cache, "cross": {
            k: v.to(cross_dtype) for k, v in kv.items()}})
    h = norm(cfg, params["decoder"]["final_norm"], h[:, -1:])
    return unembed(cfg, params, h)[:, 0], caches


def encdec_prefill_begin(cfg: ModelConfig, params: Dict, frames: Tensor,
                         tokens: Tensor, max_len: int,
                         cache_dtype: CacheDtype = torch.bfloat16
                         ) -> Tuple[Tensor, List[Dict]]:
    """The incremental enc-dec prefill's start: one encoder pass, each
    decoder layer's cross K/V built from it and cached (in the float
    dtype :func:`encdec_prefill` keeps them in), empty self-caches of
    ``max_len``, and the decoder inputs ``h`` (B, S, D) with their
    positions."""
    enc = encode(cfg, params, frames)
    h = decoder_inputs(cfg, params, tokens)
    cross_dtype = _float_cache_dtype(cache_dtype)
    caches = []
    for p in params["decoder"]["layers"]:
        kv = attn.cross_attention_kv(cfg, p["xattn"], enc, "xattn")
        caches.append({
            "self": attn.init_kv_cache(cfg, h.shape[0], max_len, h.device,
                                       cache_dtype),
            "cross": {k: v.to(cross_dtype) for k, v in kv.items()}})
    return h, caches


def encdec_prefill_step(cfg: ModelConfig, params: Dict, h_chunk: Tensor,
                        start: int, caches: List[Dict]
                        ) -> Tuple[Tensor, List[Dict]]:
    """One decoder prefill chunk at positions [start, start + C): the
    self-attention continues from its cache, the cross-attention reads the
    cached encoder K/V (cast to the compute dtype, as decode reads
    them)."""
    dtype = compute_dtype(cfg)
    b, c, _ = h_chunk.shape
    positions = _positions_from(start, b, c, h_chunk.device)
    h = h_chunk
    for p, cache in zip(params["decoder"]["layers"], caches):
        lp = p["layer"]
        y, _ = attn.attention_prefill(cfg, lp["mixer"],
                                      norm(cfg, lp["norm1"], h), positions,
                                      cache["self"], name="layer.mixer",
                                      start=start)
        kv = {k: v.to(dtype) for k, v in cache["cross"].items()}
        h = _cross_residual(cfg, p, h + y, kv)
    return h, caches


def encdec_prefill_finish(cfg: ModelConfig, params: Dict, h_last: Tensor
                          ) -> Tensor:
    """Next-token logits (B, V) from the last chunk's decoder output."""
    h = norm(cfg, params["decoder"]["final_norm"], h_last[:, -1:])
    return unembed(cfg, params, h)[:, 0]


def encdec_prefill_chunked(cfg: ModelConfig, params: Dict, frames: Tensor,
                           tokens: Tensor, max_len: int, chunk: int,
                           cache_dtype: CacheDtype = torch.bfloat16
                           ) -> Tuple[Tensor, List[Dict]]:
    """:func:`encdec_prefill` with the decoder prompt ``chunk`` positions
    at a time: the encoder runs once and the cross K/V are built once."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    h, caches = encdec_prefill_begin(cfg, params, frames, tokens, max_len,
                                     cache_dtype)
    s = h.shape[1]
    for c0 in range(0, s, chunk):
        hc, caches = encdec_prefill_step(cfg, params, h[:, c0:c0 + chunk],
                                         c0, caches)
    return encdec_prefill_finish(cfg, params, hc), caches


@functools.lru_cache(maxsize=4)
def _position_table(seq_len: int, d_model: int, dtype: torch.dtype,
                    device: torch.device) -> Tensor:
    return sinusoidal_positions(seq_len, d_model, device).to(dtype)


def encdec_decode_step(cfg: ModelConfig, params: Dict, token: Tensor,
                       pos: Tensor, caches: List[Dict]
                       ) -> Tuple[Tensor, List[Dict]]:
    """One decoder step: token (B,) at positions pos (B,) → logits (B, V)
    and ``caches``, each self-cache written in place (a captured step
    replays on the same buffers). The position row is gathered by the
    device ``pos`` from a table of ``max_seq_len`` rows built once per
    (config width, dtype, device), so a captured step reads it from the
    device."""
    dtype = compute_dtype(cfg)
    h = embed(params["embed"], token[:, None], dtype)
    table = _position_table(cfg.max_seq_len, cfg.d_model, dtype, h.device)
    h = h + table[pos][:, None, :]
    for p, cache in zip(params["decoder"]["layers"], caches):
        lp = p["layer"]
        y, _ = attn.attention_decode(cfg, lp["mixer"],
                                     norm(cfg, lp["norm1"], h), pos,
                                     cache["self"], name="layer.mixer")
        kv = {k: v.to(dtype) for k, v in cache["cross"].items()}
        h = _cross_residual(cfg, p, h + y, kv)
    h = norm(cfg, params["decoder"]["final_norm"], h)
    return unembed(cfg, params, h)[:, 0], caches
