"""Fake input stand-ins for every (arch x shape) cell of the dry run: the
twin of the JAX package's ``src/repro/launch/specs.py:30-130``.

Every function builds its tree under the caller's ``FakeTensorMode``
(``launch/cost.fake_mode``) on ``device`` (default ``launch/cost.
fake_device()``, the card where torch has one): shapes
and dtypes only, nothing allocated, on a host with no card too (deepseek-
v3-671b's 671,025,397,760 parameters are never built). A function called
outside a fake mode raises.

  train   → (TrainState, batch{tokens[, embeds|frames]})
  prefill → (params, batch)
  decode  → (params packed or float, token (B,), pos (B,), caches)

The global trees have the JAX package's shapes and dtypes but for the
indices: tokens and positions are int64, as the port's steps take them
(``F.cross_entropy`` and torch's indexing), where JAX has int32. Params are
in the port's layout (per-layer lists; ``convert.stack_layers`` gives the
JAX one), a ``TrainState``'s in the JAX layout, as training keeps it.

:func:`input_specs` returns each rank's own blocks under the port's
placement rules (``distributed/sharding.py``), new tensors of the block
shapes, so that an argument's bytes are the rank's: the params by
``param_pspecs`` (a packed weight's codes, scales and zeros as the JAX
package's children ``/0 /1 /2``), the train state by
``train_state_pspecs``, the prefill and decode batches and the caches by
``batch_pspecs`` / ``cache_pspecs`` over the data parallel axes. A train
cell's ``model`` axis computes its share (``make_sharded_train_step``
gathers the leaves ``sharding.model_split`` splits over the data axes
only: attention by heads where the heads and kv-heads divide the axis,
or by q-heads where the axis is a multiple of the kv-heads, MLA by
heads, the dense MLP by ``d_ff``, Mamba by ``d_inner``, RG-LRU by
``lru_width``, routed experts by E, the MTP projection by its columns,
the embedding and head by vocab). Prefill and
decode cells gather the whole parameters and each rank runs the
one-device step on its batch block, so a cache keeps every head
(ROADMAP.md queue 1 item 26). The train batch stays global, as
``make_sharded_train_step`` takes it (it takes each rank's block
itself).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch._guards import detect_fake_mode

from repro_torch.config import Config
from repro_torch.configs.registry import ShapeSpec
from repro_torch.core.pipeline import pack_for_serving
from repro_torch.core.quant import QuantizedTensor
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention as attn
from repro_torch.models import transformer as T
from repro_torch.training.train_step import TrainState, init_train_state

_QT_CHILDREN = ("packed", "scales", "zeros")


def _need_fake(device: Optional[str]) -> str:
    if detect_fake_mode() is None:
        raise RuntimeError("launch.specs builds fake trees: call it under "
                           "a FakeTensorMode (launch.cost.fake_mode)")
    from repro_torch.launch.cost import fake_device
    return device or fake_device()


def _gen() -> torch.Generator:
    # a host generator: under a fake mode it draws nothing, and a card's
    # generator cannot be made on a host without one
    return torch.Generator()


def batch_specs(cfg: Config, shape: ShapeSpec,
                device: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The global batch: tokens, an encoder-decoder's ``frames`` or a
    frontend's ``embeds`` (bf16), as the JAX package's."""
    device = _need_fake(device)
    mc = cfg.model
    b = shape.global_batch
    out: Dict[str, torch.Tensor] = {}
    tok = dict(dtype=torch.int64, device=device)
    if mc.is_encoder_decoder:
        out["frames"] = torch.empty((b, mc.encoder_seq_len, mc.d_model),
                                    dtype=torch.bfloat16, device=device)
        out["tokens"] = torch.empty((b, shape.seq_len), **tok)
    elif mc.frontend in ("vision", "audio") and mc.frontend_tokens > 0:
        n_front = min(mc.frontend_tokens, shape.seq_len // 2)
        out["embeds"] = torch.empty((b, n_front, mc.d_model),
                                    dtype=torch.bfloat16, device=device)
        out["tokens"] = torch.empty((b, shape.seq_len - n_front), **tok)
    else:
        out["tokens"] = torch.empty((b, shape.seq_len), **tok)
    return out


def params_specs(cfg: Config, quantized: bool = False,
                 device: Optional[str] = None) -> Dict:
    """The whole parameter tree in the port's layout, its float leaves in
    ``model.dtype`` where the JAX package's stand-ins cast them (leaves of
    two or more dims in its layout, where a layer's leaves carry the
    stacked layer axis: a layer's biases and norm scales too), or packed
    for serving (``pack_for_serving`` on a fresh grid)."""
    device = _need_fake(device)
    mc = cfg.model
    p = stand_in_dtypes(mc, T.init_encdec_params(mc, _gen(), device)
                        if mc.is_encoder_decoder
                        else T.init_params(mc, _gen(), device))
    return pack_for_serving(cfg, p) if quantized else p


def stand_in_dtypes(mc, params: Dict) -> Dict:
    """``params`` (the port's layout) with the JAX stand-ins' dtypes: fp32
    leaves of two or more dims in the JAX layout (a layer's leaves carry
    its stacked axis) in ``model.dtype``. Real tensors too: a step run on
    the card at a dry-run cell's dtypes."""
    dt = getattr(torch, mc.dtype)

    def cast(tree, stacked: bool):
        if isinstance(tree, dict):
            return {k: cast(v, stacked or k == "layers")
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v, stacked) for v in tree]
        if tree.dtype == torch.float32 and tree.dim() + stacked >= 2:
            return tree.to(dt)
        return tree
    return cast(params, False)


def state_specs(cfg: Config, device: Optional[str] = None) -> TrainState:
    """The whole step-0 ``TrainState`` (JAX layout, ``model.param_dtype``,
    fp32 or int8 moments)."""
    device = _need_fake(device)
    return init_train_state(cfg, device)


def cache_specs(cfg: Config, shape: ShapeSpec, device: Optional[str] = None,
                dtype: Any = torch.bfloat16) -> list:
    """Every layer's cache of ``shape.seq_len`` slots for the global batch
    (``dtype`` ``"int8"`` the int8 KV layout); an encoder-decoder's
    decoder layers each ``{"self", "cross"}``, the cross K/V over the
    encoder's frames."""
    device = _need_fake(device)
    mc = cfg.model
    b = shape.global_batch
    if mc.is_encoder_decoder:
        cross = T._float_cache_dtype(dtype)
        kv = (b, mc.encoder_seq_len, mc.num_kv_heads, mc.head_dim)
        return [{"self": attn.init_kv_cache(mc, b, shape.seq_len, device,
                                            dtype),
                 "cross": {"k": torch.empty(kv, dtype=cross, device=device),
                           "v": torch.empty(kv, dtype=cross,
                                            device=device)}}
                for _ in range(mc.num_layers)]
    return T.init_caches(mc, b, shape.seq_len, device, dtype)


def decode_token_specs(shape: ShapeSpec, device: Optional[str] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    device = _need_fake(device)
    b = shape.global_batch
    return (torch.empty((b,), dtype=torch.int64, device=device),
            torch.empty((b,), dtype=torch.int64, device=device))


# -- each rank's blocks ------------------------------------------------------

def open_packed(tree):
    """A packed tree with each ``QuantizedTensor`` as the dict of its
    children ``{"0": codes, "1": scales, "2": zeros}`` (the JAX package's
    paths ``w/0``, ``w/1``, ``w/2``, which the placement rules name), and
    ``{path: (shape, bits, group_size)}`` to close it again."""
    meta: Dict[str, tuple] = {}

    def walk(node, path):
        if isinstance(node, QuantizedTensor):
            meta[path] = (node.shape, node.bits, node.group_size)
            return {str(i): getattr(node, c)
                    for i, c in enumerate(_QT_CHILDREN)}
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}/{i}" if path else str(i))
                    for i, v in enumerate(node)]
        return node
    return walk(tree, ""), meta


def close_packed(tree, meta: Dict[str, tuple]):
    """The inverse of :func:`open_packed`."""
    def walk(node, path):
        if path in meta:
            shape, bits, gs = meta[path]
            return QuantizedTensor(node["0"], node["1"], node["2"], shape,
                                   bits, gs)
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}/{i}" if path else str(i))
                    for i, v in enumerate(node)]
        return node
    return walk(tree, "")


def own_blocks(tree, specs, mesh):
    """New tensors holding this rank's block of each leaf (a view of a
    fake leaf would carry the whole leaf's storage)."""
    return shd._map_specs(
        lambda x, s: shd.local_block(x, s, mesh).clone(), tree, specs)


def input_specs(cfg: Config, shape: ShapeSpec, rules: shd.Rules, *,
                quantized_decode: bool = True,
                device: Optional[str] = None) -> Dict[str, Any]:
    """Everything a cell's step runs on, as this rank's blocks (module
    docstring), with the spec trees the step gathers by: ``params`` /
    ``param_specs`` (a packed tree open, ``packed_meta`` to close it),
    ``state`` / ``state_specs``, ``batch``, ``token`` / ``pos``,
    ``caches`` (int8 under ``serve.kv_cache=int8``, else bf16)."""
    mesh, fsdp = rules.mesh, cfg.parallel.fsdp
    if shape.kind == "train":
        state = state_specs(cfg, device)
        sspecs = shd.train_state_pspecs(state, rules, fsdp)
        return {"state": own_blocks(state, sspecs, mesh),
                "state_specs": sspecs,
                "batch": batch_specs(cfg, shape, device)}
    quantized = shape.kind == "decode" and quantized_decode
    params, meta = open_packed(params_specs(cfg, quantized, device))
    pspecs = shd.param_pspecs(params, rules, fsdp)
    batch = batch_specs(cfg, shape, device)
    out = {"params": own_blocks(params, pspecs, mesh), "param_specs": pspecs,
           "packed_meta": meta}
    del params
    if shape.kind == "prefill":
        out["batch"] = own_blocks(batch, shd.batch_pspecs(batch, rules),
                                  mesh)
        return out
    if shape.kind != "decode":
        raise ValueError(shape.kind)
    cdt = "int8" if cfg.serve.kv_cache == "int8" else torch.bfloat16
    tok, pos = decode_token_specs(shape, device)
    tp = {"t": tok, "p": pos}
    tp = own_blocks(tp, shd.batch_pspecs(tp, rules), mesh)
    caches = cache_specs(cfg, shape, device, cdt)
    # serving splits no compute over the model axis (item 26): a rank's
    # cache holds its batch block and every head
    crules = dataclasses.replace(rules, tp_axis=None)
    out.update(token=tp["t"], pos=tp["p"],
               caches=own_blocks(caches, shd.cache_pspecs(caches, crules),
                                 mesh))
    return out
