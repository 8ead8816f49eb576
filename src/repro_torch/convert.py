"""Carry parameter trees between torch and plain host containers.

``jax.random`` bits cannot be reproduced in torch, so the tests give both
packages the same weights by converting the JAX tree. The caller turns the
tree's leaves into numpy arrays first (``np.asarray(jax.device_get(a))``);
this module imports nothing from JAX. A JAX trainer checkpoint read through
``distributed.checkpoint`` comes in the same way, its leaves as CPU
tensors.

:func:`stack_layers` / :func:`unstack_layers` carry a float tree of
tensors between the port's per-layer list and the JAX layout that training
keeps (``training/train_step.py``: its leaves are the JAX TrainState's,
so a trainer checkpoint has the JAX package's paths both ways).

:func:`tree_to_numpy` is the other direction, the payload of a packed
serving artifact: plain dicts and lists, numpy arrays and Python scalars,
a ``QuantizedTensor`` as the dict of its six fields and a bfloat16 tensor
as ``{"bfloat16": <int16 view>}`` (numpy has no bfloat16), so it loads
with numpy alone and :func:`params_from_numpy` reads it back.
"""
from __future__ import annotations

import sys
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core.quant import QuantizedTensor
from repro_torch.models.transformer import segments

_QT_FIELDS = ("packed", "scales", "zeros", "shape", "bits", "group_size")
BF16_TAG = "bfloat16"


def _is_quantized(v: Any) -> bool:
    if isinstance(v, dict):
        return all(k in v for k in _QT_FIELDS)
    return all(hasattr(v, k) for k in _QT_FIELDS)


def _qt_fields(v: Any) -> Dict[str, Any]:
    if isinstance(v, dict):
        return {k: v[k] for k in _QT_FIELDS}
    return {k: getattr(v, k) for k in _QT_FIELDS}


def _is_bf16_tagged(v: Any) -> bool:
    return isinstance(v, dict) and list(v) == [BF16_TAG]


def tensor_from_numpy(a: Any, device="cpu") -> torch.Tensor:
    """numpy → torch; bfloat16 arrays go through a 16-bit integer view.
    A torch tensor (a checkpoint's leaf) is moved to ``device`` as is."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    if _is_bf16_tagged(a):
        bits = np.ascontiguousarray(a[BF16_TAG]).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _take(a: Any, take) -> Any:
    """Index ``take`` of a leaf's leading axis (numpy, tensor, or a
    bfloat16-tagged int16 view)."""
    if take is None:
        return a
    if _is_bf16_tagged(a):
        return {BF16_TAG: np.asarray(a[BF16_TAG])[take]}
    return (a if isinstance(a, torch.Tensor) else np.asarray(a))[take]


def _convert(v: Any, device, take=None) -> Any:
    """Convert a subtree; ``take`` = index into a leading (layer) axis."""
    if _is_quantized(v):
        f = _qt_fields(v)
        parts = [f["packed"], f["scales"], f["zeros"]]
        shape = tuple(int(s) for s in f["shape"])
        if take is not None:
            parts = [_take(p, take) for p in parts]
            shape = shape[1:]
        packed, scales, zeros = (tensor_from_numpy(p, device) for p in parts)
        return QuantizedTensor(packed, scales, zeros, shape, f["bits"],
                               f["group_size"])
    if isinstance(v, dict) and not _is_bf16_tagged(v):
        return {k: _convert(x, device, take) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_convert(x, device, take) for x in v]
    return tensor_from_numpy(_take(v, take), device)


def _layer_count(seg: Dict) -> int:
    v = seg
    while isinstance(v, dict) and not _is_quantized(v):
        v = next(iter(v.values()))
    if _is_quantized(v):
        v = _qt_fields(v)["packed"]
    return int(v.shape[0] if isinstance(v, torch.Tensor) else np.shape(v)[0])


def _unstack(stacked: Any, device) -> List[Any]:
    """A subtree whose leaves carry a leading (count,) layer axis → the
    list of its layers."""
    return [_convert(stacked, device, take=c)
            for c in range(_layer_count(stacked))]


def params_from_numpy(tree: Dict, device="cpu") -> Dict:
    """A JAX param tree (numpy leaves) → the port's tree.

    Decoder-only: ``tree["blocks"]`` holds segments ``{"sub0": ...,
    "sub1": ...}`` whose leaves carry a leading (count,) layer axis; they
    unstack into the port's flat ``"layers"`` list in layer order
    (element-major, then sub-layer). Encoder-decoder: ``encoder.layers``
    and ``decoder.layers`` carry that axis and unstack into per-layer
    lists. ``qscales``/``qzeros`` leaves are kept. Packed
    ``QuantizedTensor`` leaves (objects or dicts with packed / scales /
    zeros / shape / bits / group_size) split their layer axis too. A tree
    already in the port's layout (a ``"layers"`` list) converts leaf for
    leaf.
    """
    out: Dict[str, Any] = {}
    layers: List[Dict] = []
    for k, v in tree.items():
        if k in ("encoder", "decoder") and isinstance(v.get("layers"), dict):
            out[k] = {kk: (_unstack(vv, device) if kk == "layers"
                           else _convert(vv, device))
                      for kk, vv in v.items()}
            continue
        if k != "blocks":
            out[k] = _convert(v, device)
            continue
        for seg in v:
            subs = sorted(seg, key=lambda s: int(s[3:]))
            for c in range(_layer_count(seg)):
                for s in subs:
                    layers.append(_convert(seg[s], device, take=c))
    if "blocks" in tree:
        out["layers"] = layers
    return out


def tree_from_numpy(tree: Any, device="cpu") -> Any:
    """A tree of numpy leaves → the same structure of tensors on
    ``device``, leaf for leaf (a JAX TrainState's parameters keep their
    stacked layout; ``QuantizedTensor`` leaves as in
    :func:`params_from_numpy`)."""
    return _convert(tree, device)


def _stack_tensors(trees: List[Any]) -> Any:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_tensors([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def stack_layers(mc, params: Dict) -> Dict:
    """The port's float tree → the JAX package's layout (the inverse of
    :func:`unstack_layers`): a decoder-only ``"layers"`` list stacked into
    ``"blocks"``, one ``{"sub<i>": ...}`` segment per scanned segment of
    ``transformer.segments(mc)``, every leaf with a leading (count,) axis;
    an encoder-decoder's ``encoder.layers`` / ``decoder.layers`` stacked
    along a leading layer axis. Other subtrees are kept."""
    if mc.is_encoder_decoder:
        return {k: ({kk: (_stack_tensors(vv) if kk == "layers" else vv)
                     for kk, vv in v.items()}
                    if k in ("encoder", "decoder") else v)
                for k, v in params.items()}
    out = {k: v for k, v in params.items() if k != "layers"}
    layers, li, blocks = params["layers"], 0, []
    for seg in segments(mc):
        n = len(seg.specs)
        elems = [layers[li + c * n:li + (c + 1) * n]
                 for c in range(seg.count)]
        li += n * seg.count
        blocks.append({f"sub{i}": _stack_tensors([e[i] for e in elems])
                       for i in range(n)})
    out["blocks"] = blocks
    return out


def unstack_layers(params: Dict) -> Dict:
    """A tree in the JAX layout whose leaves are tensors → the port's
    layout, each layer's leaves views into the stacked ones (so autograd
    brings a layer's gradient back to its slice of the stacked leaf)."""
    dev = next(iter(_tensor_leaves(params))).device
    return params_from_numpy(params, dev)


def _tensor_leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _stack(trees: List[Any]) -> Any:
    """Per-layer plain trees of one structure → one tree whose leaves
    carry a leading (count,) layer axis (a packed leaf's ``shape`` gains
    it too)."""
    first = trees[0]
    if isinstance(first, dict):
        if any(sorted(t) != sorted(first) for t in trees):
            raise ValueError("layers of different structure do not stack")
        out = {k: _stack([t[k] for t in trees]) for k in first}
        if _is_quantized(first):
            out["shape"] = [len(trees), *first["shape"]]
        return out
    if isinstance(first, np.ndarray):
        return np.stack(trees)
    if any(t != first for t in trees):
        raise ValueError(f"layers differ in a scalar leaf: {trees}")
    return first


def tree_to_numpy(tree: Any) -> Any:
    """A torch tree → plain containers with numpy leaves (module
    docstring): the inverse of :func:`params_from_numpy`, bit for bit, up
    to the order of dict keys. An encoder-decoder's ``encoder.layers`` and
    ``decoder.layers`` lists are stacked along a leading layer axis, as
    the JAX package holds them (so an artifact and a JAX trainer
    checkpoint share the layout); a decoder-only tree keeps the port's
    ``"layers"`` list."""
    if (isinstance(tree, dict) and "encoder" in tree and "decoder" in tree
            and isinstance(tree["decoder"].get("layers"), list)):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if k in ("encoder", "decoder"):
                out[sys.intern(k)] = {sys.intern(kk): (
                    _stack([tree_to_numpy(x) for x in vv])
                    if kk == "layers" else tree_to_numpy(vv))
                    for kk, vv in sorted(v.items())}
            else:
                out[sys.intern(k)] = tree_to_numpy(v)
        return out
    if isinstance(tree, QuantizedTensor):
        return {k: tree_to_numpy(getattr(tree, k)) for k in _QT_FIELDS}
    if isinstance(tree, torch.Tensor):
        # C order always: a transposed view pickles in another layout
        t = tree.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {BF16_TAG: t.view(torch.int16).numpy()}
        return t.numpy()
    if isinstance(tree, dict):
        # sorted, interned keys (pickle memoizes a key by identity): the
        # payload's bytes depend on the values only, not on the order a
        # dict was filled in or where its key strings came from
        return {sys.intern(k): tree_to_numpy(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(v) for v in tree]
    return tree
