"""Carry the JAX package's parameters across to the port.

``jax.random`` bits cannot be reproduced in torch, so the tests give both
packages the same weights by converting the JAX tree. The caller turns the
tree's leaves into numpy arrays first (``np.asarray(jax.device_get(a))``);
this module imports nothing from JAX.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core.quant import QuantizedTensor

_QT_FIELDS = ("packed", "scales", "zeros", "shape", "bits", "group_size")


def _is_quantized(v: Any) -> bool:
    if isinstance(v, dict):
        return all(k in v for k in _QT_FIELDS)
    return all(hasattr(v, k) for k in _QT_FIELDS)


def _qt_fields(v: Any) -> Dict[str, Any]:
    if isinstance(v, dict):
        return {k: v[k] for k in _QT_FIELDS}
    return {k: getattr(v, k) for k in _QT_FIELDS}


def tensor_from_numpy(a: Any, device="cpu") -> torch.Tensor:
    """numpy → torch; bfloat16 arrays go through a 16-bit integer view."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _convert(v: Any, device, take=None) -> Any:
    """Convert a subtree; ``take`` = index into a leading (layer) axis."""
    if _is_quantized(v):
        f = _qt_fields(v)
        parts = [f["packed"], f["scales"], f["zeros"]]
        shape = tuple(int(s) for s in f["shape"])
        if take is not None:
            parts = [np.asarray(p)[take] for p in parts]
            shape = shape[1:]
        packed, scales, zeros = (tensor_from_numpy(p, device) for p in parts)
        return QuantizedTensor(packed, scales, zeros, shape, f["bits"],
                               f["group_size"])
    if isinstance(v, dict):
        return {k: _convert(x, device, take) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_convert(x, device, take) for x in v]
    a = np.asarray(v)
    return tensor_from_numpy(a if take is None else a[take], device)


def _layer_count(seg: Dict) -> int:
    v = seg
    while isinstance(v, dict) and not _is_quantized(v):
        v = next(iter(v.values()))
    return int(np.shape(_qt_fields(v)["packed"] if _is_quantized(v)
                        else v)[0])


def params_from_numpy(tree: Dict, device="cpu") -> Dict:
    """The JAX decoder-only param tree (numpy leaves) → the port's tree.

    ``tree["blocks"]`` holds segments ``{"sub0": ..., "sub1": ...}`` whose
    leaves carry a leading (count,) layer axis; they unstack into the
    port's flat ``"layers"`` list in layer order (element-major, then
    sub-layer). ``qscales``/``qzeros`` leaves are kept. Packed
    ``QuantizedTensor`` leaves (objects or dicts with packed / scales /
    zeros / shape / bits / group_size) split their layer axis too.
    """
    out: Dict[str, Any] = {}
    layers: List[Dict] = []
    for k, v in tree.items():
        if k != "blocks":
            out[k] = _convert(v, device)
            continue
        for seg in v:
            subs = sorted(seg, key=lambda s: int(s[3:]))
            for c in range(_layer_count(seg)):
                for s in subs:
                    layers.append(_convert(seg[s], device, take=c))
    out["layers"] = layers
    return out
