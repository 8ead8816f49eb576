"""Grouped-query attention: self-attention forward, prefill and decode,
the encoder-decoder's cross-attention, and deepseek's multi-head latent
attention (MLA, at the end of the module).

The math mirrors the JAX package's ``opt_attention`` path: queries are
pre-scaled in fp32 and cast to the compute dtype, scores and values are
products of compute-dtype operands accumulated in fp32, softmax runs in
fp32 with masked slots at -1e30. ``model.opt_attention=false`` selects the
reference's naive baseline: the query scaled in fp32 and kept there,
fp32 × fp32 score and value products with the probabilities unrounded,
and, at decode on a bf16 cache, the head-repeated cache materialized in
fp32 (an int8 cache is read by ``ops.int8_kv_attention`` under either
value, as in the reference). The products are plain matmuls and a
softmax (no fused attention operator). Query head h reads kv-head
``h // n_rep`` (``n_rep = num_heads // num_kv_heads``), the order of
``repeat_kv``.

Caches (per layer; a slot's key position is -1 until it is written) are
written in place. A full-attention layer's cache holds ``max_len`` slots,
position p in slot p. A windowed layer ("swa"/"local", ``window`` > 0)
holds a ring of ``W = min(window, max_len)`` slots, position p in slot
``p % W``: the prefill keeps the last W positions of a longer prompt, and
decode overwrites the oldest slot, so its memory stays bounded however
long the session. The layouts:

  - bf16: ``{"k", "v"}`` (B, S_cache, KV, hd);
  - int8 (``serve.kv_cache=int8``): ``"k"``/``"v"`` int8 codes at the same
    shapes, per-(slot, kv-head, block) f32 scales ``"k_scale"``/
    ``"v_scale"`` (B, S_cache, KV, hd // block) with block
    ``kv_codec.default_kv_block(hd)``, and per-lane f32 error-feedback
    accumulators ``"k_err"``/``"v_err"`` (B, KV, hd) that decode appends
    fold in (``e <- x - dec(enc(x + e))``). Decode reads the history
    through ``ops.int8_kv_attention``.

``cfg.attn_logits_softcap`` > 0 caps every score as ``tanh(s / c) * c``
before the mask, in prefill and decode. RoPE rotates q and k only when
``cfg.use_rope`` (whisper adds fixed sinusoidal positions to its inputs
instead). The cross-attention's encoder K/V (``cross_attention_kv``) are
computed once a request; every decoder query attends to all of them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import kv_codec, ops
from repro_torch.models.layers import apply_rope, tanh_softcap
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
                    kv_positions: Tensor, *, causal: bool = True,
                    window: int = 0, softcap: float = 0.0,
                    chunk: int = 512, opt: bool = True) -> Tensor:
    """Attention. q/k/v (B, S, H, hd); positions (B, Sq) / (B, Sk), a
    negative one a padding slot. A key is seen when ``causal`` and
    ``kpos <= qpos`` (every key when not ``causal``), and with ``window``
    > 0 also ``kpos > qpos - window``; scores are soft-capped
    (``softcap`` > 0) before the mask. Queries go in chunks of ``chunk``; each chunk takes a
    full softmax over the keys. ``opt`` False is the naive baseline: the
    scaled query and the probabilities stay fp32 (module docstring).
    Returns (B, Sq, H, hd) in q's dtype."""
    b, sq, h, hd = q.shape
    scale = hd ** -0.5
    kT = k.permute(0, 2, 3, 1)                      # (B, H, hd, Sk)
    vT = v.permute(0, 2, 1, 3)                      # (B, H, Sk, hd)
    dk = kv_positions[:, None, None, :]
    outs = []
    for c0 in range(0, sq, chunk):
        qi = q[:, c0:c0 + chunk]
        pi = q_positions[:, c0:c0 + chunk]
        qs = qi.float() * scale
        if opt:
            qs = qs.to(qi.dtype)
        s = tanh_softcap(_mm(qs.permute(0, 2, 1, 3), kT), softcap)
        dq = pi[:, None, :, None]
        mask = (dq >= 0) & (dk >= 0)
        if causal:
            mask = mask & (dq >= dk)
        if window > 0:
            mask = mask & (dk > dq - window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        o = _mm(p.to(vT.dtype) if opt else p, vT)   # (B, H, c, hd)
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
                      positions: Tensor, *, causal: bool = True,
                      window: int = 0, name: str = "attn",
                      use_rope: Optional[bool] = None,
                      reduce=None) -> Tensor:
    """Self-attention over a full sequence: causal (windowed when
    ``window`` > 0) or, with ``causal=False``, bidirectional (whisper's
    encoder). RoPE is applied when ``use_rope`` says so (None: when
    ``cfg.use_rope``). x (B, S, D). ``reduce``: the o product's
    row-parallel sum (``linear.dense``), where ``cfg`` holds a rank's
    heads."""
    q, k, v = _project_qkv(cfg, p, x, name)
    if cfg.use_rope if use_rope is None else use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    n_rep = _n_rep(cfg)
    o = _attend_chunked(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                        positions, positions, causal=causal, window=window,
                        softcap=cfg.attn_logits_softcap,
                        opt=cfg.opt_attention)
    b, s = x.shape[:2]
    return dense(p["o"], o.reshape(b, s, -1), f"{name}.o", reduce)


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
                      positions: Tensor, cache: Dict, *, window: int = 0,
                      name: str = "attn", start: Optional[int] = None
                      ) -> Tuple[Tensor, Dict]:
    """Causal attention over the prompt and the cache write: at [0, S),
    or, for a ring (``window`` > 0) shorter than the prompt, the last W
    positions at slots ``pos % W``. Queries attend to the fresh float K/V,
    not to the cache, so the cache layout does not move the prefill
    output. The cache is written in place; the int8 layout's error
    accumulators stay untouched (error feedback is a decode-append
    recurrence).

    ``start`` is the chunked prefill's continuation: ``x`` holds positions
    ``[start, start + S)`` and the cache the positions before ``start``.
    The queries attend to that history, read from the cache before the
    chunk writes (an int8 history dequantized, a ring's slots by
    :func:`cache_key_positions` at ``start - 1``), and to the chunk's own
    K/V; the chunk is then written at ``[start, start + S)``, on a ring by
    slot (``pos % W``), so a chunk may straddle the wrap."""
    q, k, v = _project_qkv(cfg, p, x, name)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    n_rep = _n_rep(cfg)
    b, s = x.shape[:2]
    w_cache = cache["k"].shape[1]
    quantized = kv_cache_quantized(cache)
    if start is None:
        k_att, v_att, kv_pos = k, v, positions
    else:
        last = torch.full((b,), start - 1, dtype=torch.long, device=x.device)
        old = cache_key_positions(last, w_cache, window)
        if quantized:
            blk = kv_cache_block(cache)
            k_hist = kv_codec.dec_int8_blocks(cache["k"], cache["k_scale"],
                                              blk).to(k.dtype)
            v_hist = kv_codec.dec_int8_blocks(cache["v"], cache["v_scale"],
                                              blk).to(v.dtype)
        else:
            k_hist, v_hist = cache["k"].to(k.dtype), cache["v"].to(v.dtype)
        k_att = torch.cat([k_hist, k], dim=1)
        v_att = torch.cat([v_hist, v], dim=1)
        kv_pos = torch.cat([old, positions], dim=1)
    o = _attend_chunked(q, repeat_kv(k_att, n_rep), repeat_kv(v_att, n_rep),
                        positions, kv_pos, window=window,
                        softcap=cfg.attn_logits_softcap,
                        opt=cfg.opt_attention)
    y = dense(p["o"], o.reshape(b, s, -1), f"{name}.o")
    bidx = torch.arange(b, device=x.device)[:, None]
    if window > 0 and w_cache < s:
        k, v = k[:, -w_cache:], v[:, -w_cache:]
        idx = (bidx, positions[:, -w_cache:] % w_cache)           # (B, W)
    elif window > 0 and start is not None:
        idx = (bidx, positions % w_cache)                         # (B, S)
    else:
        off = start or 0
        idx = (slice(None), slice(off, off + s))
    if quantized:
        blk = kv_cache_block(cache)
        cache["k"][idx], cache["k_scale"][idx] = \
            kv_codec.enc_int8_blocks(k, blk)
        cache["v"][idx], cache["v_scale"][idx] = \
            kv_codec.enc_int8_blocks(v, blk)
    else:
        cache["k"][idx] = k.to(cache["k"].dtype)
        cache["v"][idx] = v.to(cache["v"].dtype)
    return y, cache


def cache_key_positions(pos: Tensor, cache_len: int, window: int = 0
                        ) -> Tensor:
    """(B, cache_len) position held by each slot once ``pos`` (B,) was
    written, -1 for a slot that holds none. Full cache (``window`` 0):
    slot i holds position i while i <= pos. Ring (``window`` > 0): slot i
    holds the largest p <= pos with p % cache_len == i, valid while p >= 0
    and p > pos - min(window, cache_len). Computed on pos's device, so a
    captured decode step replays it across the wrap point."""
    idx = torch.arange(cache_len, device=pos.device)[None, :]
    last = pos[:, None]
    if window > 0:
        kpos = last - (last - idx) % cache_len
        ok = (kpos >= 0) & (kpos > last - min(window, cache_len))
    else:
        kpos, ok = idx.expand(pos.shape[0], cache_len), idx <= last
    return torch.where(ok, kpos, torch.full_like(kpos, -1))


def _prescaled_groups(q: Tensor, kv: int) -> Tensor:
    """(B, H, hd) decode queries → (B, KV, n_rep, hd) times hd^-0.5 in q's
    dtype: the scale is rounded to that dtype first and the product back
    to it, as JAX multiplies an array by a Python float."""
    b, h, hd = q.shape
    scale = float(torch.tensor(hd ** -0.5, dtype=q.dtype))
    return (q * scale).reshape(b, kv, h // kv, hd)


def attention_decode(cfg: ModelConfig, p: Dict, x: Tensor, pos: Tensor,
                     cache: Dict, *, window: int = 0, name: str = "attn"
                     ) -> Tuple[Tensor, Dict]:
    """One-token decode against the cache. x (B, 1, D); pos (B,). The new
    K/V row is written in place at slot ``pos`` (a ring: ``pos % W``); on
    the int8 layout it is appended with error feedback and the history is
    read by ``ops.int8_kv_attention`` (under either ``opt_attention``).
    The naive baseline on a bf16 cache materializes the head-repeated
    cache in fp32 and takes fp32 products, as the reference's does."""
    b = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(cfg, p, x, name)
    if cfg.use_rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    cache_len = ck.shape[1]
    slot = pos % cache_len if window > 0 else pos
    bidx = torch.arange(b, device=x.device)
    kpos = cache_key_positions(pos, cache_len, window)
    qg = _prescaled_groups(q[:, 0], kv)
    cap = cfg.attn_logits_softcap
    if kv_cache_quantized(cache):
        blk = kv_cache_block(cache)
        for leaf, new in (("k", k), ("v", v)):
            xf = new[:, 0].float() + cache[f"{leaf}_err"]
            codes, scales = kv_codec.enc_int8_blocks(xf, blk)
            cache[leaf][bidx, slot] = codes
            cache[f"{leaf}_scale"][bidx, slot] = scales
            cache[f"{leaf}_err"].copy_(
                xf - kv_codec.dec_int8_blocks(codes, scales, blk))
        o = ops.int8_kv_attention(qg, ck, cache["k_scale"], cv,
                                  cache["v_scale"], kpos.to(torch.int32),
                                  kv_block=blk, softcap=cap).to(x.dtype)
    else:
        ck[bidx, slot] = k[:, 0].to(ck.dtype)
        cv[bidx, slot] = v[:, 0].to(cv.dtype)
        if cfg.opt_attention:
            s = _mm(qg.to(ck.dtype), ck.permute(0, 2, 3, 1))  # B,KV,R,S
            s = torch.where(kpos[:, None, None, :] >= 0,
                            tanh_softcap(s, cap),
                            torch.full_like(s, NEG_INF))
            pw = torch.softmax(s, dim=-1)
            o = _mm(pw.to(cv.dtype), cv.permute(0, 2, 1, 3)).to(x.dtype)
        else:
            kk = repeat_kv(ck, h // kv).float().permute(0, 2, 3, 1)
            vv = repeat_kv(cv, h // kv).float().permute(0, 2, 1, 3)
            qf = (q[:, 0].float() * hd ** -0.5)[:, :, None, :]   # B,H,1,hd
            s = tanh_softcap(qf @ kk, cap)                       # B,H,1,S
            s = torch.where(kpos[:, None, None, :] >= 0, s,
                            torch.full_like(s, NEG_INF))
            o = (torch.softmax(s, dim=-1) @ vv).to(x.dtype)      # B,H,1,hd
    y = dense(p["o"], o.reshape(b, 1, h * hd), f"{name}.o")
    return y, cache


def init_cross_attention(cfg: ModelConfig, gen: torch.Generator, device,
                         bias: bool = True) -> Dict:
    """The decoder's cross-attention: q, k, v, o as a self-attention's."""
    return init_attention(cfg, gen, bias, device)


def cross_attention_kv(cfg: ModelConfig, p: Dict, enc: Tensor,
                       name: str = "xattn") -> Dict:
    """The encoder-side K/V, computed once a request: enc (B, Se, D) →
    ``{"k", "v"}`` (B, Se, KV, hd)."""
    b, se, _ = enc.shape
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": dense(p["k"], enc, f"{name}.k").reshape(b, se, kv, hd),
            "v": dense(p["v"], enc, f"{name}.v").reshape(b, se, kv, hd)}


def cross_attention(cfg: ModelConfig, p: Dict, x: Tensor, kv_cache: Dict,
                    name: str = "xattn", reduce=None) -> Tensor:
    """Decoder queries x (B, S, D) against the fixed encoder K/V: no
    positions, no mask. Plain products, as the JAX package computes them
    outside any Pallas kernel. ``reduce``: as :func:`attention_forward`'s."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = dense(p["q"], x, f"{name}.q").reshape(b, s, h, hd)
    n_rep = _n_rep(cfg)
    k = repeat_kv(kv_cache["k"], n_rep)
    v = repeat_kv(kv_cache["v"], n_rep)
    zeros = torch.zeros((b, 1), dtype=torch.long, device=x.device)
    o = _attend_chunked(q, k, v, zeros.expand(b, s),
                        zeros.expand(b, k.shape[1]), causal=False,
                        opt=cfg.opt_attention)
    return dense(p["o"], o.reshape(b, s, -1), f"{name}.o", reduce)


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (deepseek-v3)
# ---------------------------------------------------------------------------
#
# A token's keys and values come from its latent ckv = x W_kv_down (rank
# kv_lora_rank) and one RoPE'd key k_rope = x W_k_rope shared by all heads;
# queries from x W_q_down W_q_up. The cache holds only the latents:
# ``{"ckv": (B, S, kv_lora_rank), "krope": (B, S, qk_rope_head_dim)}`` in
# a float dtype (bf16 where the attention caches are int8, as the JAX
# package's ``_float_cache_dtype``). Every attention re-expands the
# latents through k_up / v_up: at decode the whole cache each step, as the
# reference computes it (the absorbed-weight form is another arithmetic).
# q and k are the nope ‖ rope concatenation (width nope + rope), v is
# zero-padded to that width for the shared attention and sliced after it.

def init_mla(cfg: ModelConfig, gen: torch.Generator, device) -> Dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "q_down": init_dense(gen, d, m.q_lora_rank, device=device),
        "q_up": init_dense(gen, m.q_lora_rank, h * qk_hd, device=device),
        "kv_down": init_dense(gen, d, m.kv_lora_rank, device=device),
        "k_rope": init_dense(gen, d, m.qk_rope_head_dim, device=device),
        "k_up": init_dense(gen, m.kv_lora_rank, h * m.qk_nope_head_dim,
                           device=device),
        "v_up": init_dense(gen, m.kv_lora_rank, h * m.v_head_dim,
                           device=device),
        "o": init_dense(gen, h * m.v_head_dim, d,
                        scale=(h * m.v_head_dim) ** -0.5, device=device),
    }


def _mla_qkv(cfg: ModelConfig, p: Dict, x: Tensor, positions: Tensor,
             name: str, split=None):
    """x (B, S, D) → (q_nope, q_rope (B, S, H, ·), ckv (B, S, rank),
    k_rope (B, S, rope)), the rope halves rotated. ``split`` (a sharded
    step's ``sharding.ModelSplit``; ``cfg`` and ``q_up`` at a rank's
    heads): the latents ql, ckv and k_rope, computed whole, enter one
    ``ModelSplit.copy_all``, as each rank's gradient of them is a partial
    over its heads."""
    m = cfg.mla
    b, s, _ = x.shape
    ql = dense(p["q_down"], x, f"{name}.q_down")
    ckv = dense(p["kv_down"], x, f"{name}.kv_down")
    k_rope = dense(p["k_rope"], x, f"{name}.k_rope")
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    if split is not None:
        ql, ckv, k_rope = split.copy_all(ql, ckv, k_rope)
    q = dense(p["q_up"], ql, f"{name}.q_up").reshape(
        b, s, cfg.num_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope, ckv, k_rope


def _mla_attend(cfg: ModelConfig, p: Dict, q_nope: Tensor, q_rope: Tensor,
                ckv: Tensor, k_rope: Tensor, q_positions: Tensor,
                kv_positions: Tensor, name: str, reduce=None) -> Tensor:
    """Expand the latents ckv (B, Sk, rank) to per-head K/V, attend
    causally, project out: (B, Sq, D). ``reduce``: the o product's
    row-parallel sum, where the heads are a rank's (``linear.dense``)."""
    m = cfg.mla
    b, sk = ckv.shape[:2]
    h = cfg.num_heads
    k_nope = dense(p["k_up"], ckv, f"{name}.k_up").reshape(
        b, sk, h, m.qk_nope_head_dim)
    v = dense(p["v_up"], ckv, f"{name}.v_up").reshape(b, sk, h,
                                                      m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    kr = k_rope[:, :, None, :].expand(b, sk, h, m.qk_rope_head_dim)
    k = torch.cat([k_nope, kr], dim=-1)
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    if m.v_head_dim < qk_hd:
        v = torch.nn.functional.pad(v, (0, qk_hd - m.v_head_dim))
    o = _attend_chunked(q, k, v, q_positions, kv_positions,
                        softcap=cfg.attn_logits_softcap,
                        opt=cfg.opt_attention)[..., :m.v_head_dim]
    return dense(p["o"], o.reshape(b, o.shape[1], -1), f"{name}.o", reduce)


def mla_forward(cfg: ModelConfig, p: Dict, x: Tensor, positions: Tensor,
                name: str = "attn", split=None, reduce=None) -> Tensor:
    """Causal MLA over a full sequence (no cache). x (B, S, D).
    ``split`` / ``reduce``: a sharded step's rank at its heads
    (:func:`_mla_qkv`, :func:`_mla_attend`)."""
    q_nope, q_rope, ckv, k_rope = _mla_qkv(cfg, p, x, positions, name,
                                           split)
    return _mla_attend(cfg, p, q_nope, q_rope, ckv, k_rope, positions,
                       positions, name, reduce)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                   dtype: torch.dtype = torch.bfloat16) -> Dict:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                 dtype=dtype, device=device)}


def mla_prefill(cfg: ModelConfig, p: Dict, x: Tensor, positions: Tensor,
                cache: Dict, name: str = "attn",
                start: Optional[int] = None) -> Tuple[Tensor, Dict]:
    """MLA over the prompt and the latent cache write at [0, S), in place.
    ``start``: the chunked prefill's continuation, ``x`` at positions
    ``[start, start + S)``: the queries attend to the cached latents of
    the positions before ``start`` (read before the chunk writes) and the
    chunk's own, and the chunk is written at ``[start, start + S)``."""
    q_nope, q_rope, ckv, k_rope = _mla_qkv(cfg, p, x, positions, name)
    if start is None:
        y = _mla_attend(cfg, p, q_nope, q_rope, ckv, k_rope, positions,
                        positions, name)
    else:
        b = x.shape[0]
        last = torch.full((b,), start - 1, dtype=torch.long, device=x.device)
        old = cache_key_positions(last, cache["ckv"].shape[1])
        y = _mla_attend(cfg, p, q_nope, q_rope,
                        torch.cat([cache["ckv"].to(x.dtype), ckv], dim=1),
                        torch.cat([cache["krope"].to(x.dtype), k_rope],
                                  dim=1),
                        positions, torch.cat([old, positions], dim=1), name)
    off, s = start or 0, x.shape[1]
    cache["ckv"][:, off:off + s] = ckv.to(cache["ckv"].dtype)
    cache["krope"][:, off:off + s] = k_rope.to(cache["krope"].dtype)
    return y, cache


def mla_decode(cfg: ModelConfig, p: Dict, x: Tensor, pos: Tensor,
               cache: Dict, name: str = "attn") -> Tuple[Tensor, Dict]:
    """One-token MLA decode against the latent cache. x (B, 1, D); pos
    (B,). The token's latents are written in place at slot ``pos``; then
    the whole cache is expanded and attended (slots past ``pos`` masked)."""
    b = x.shape[0]
    q_nope, q_rope, ckv, k_rope = _mla_qkv(cfg, p, x, pos[:, None], name)
    bidx = torch.arange(b, device=x.device)
    cache["ckv"][bidx, pos] = ckv[:, 0].to(cache["ckv"].dtype)
    cache["krope"][bidx, pos] = k_rope[:, 0].to(cache["krope"].dtype)
    kpos = cache_key_positions(pos, cache["ckv"].shape[1])
    y = _mla_attend(cfg, p, q_nope, q_rope, cache["ckv"].to(x.dtype),
                    cache["krope"].to(x.dtype), pos[:, None], kpos, name)
    return y, cache
