"""AdamW with optional int8 block-quantized moments.

The twin of the JAX package's ``training/optimizer.py``. With int8
moments each moment tensor is flattened into blocks of 128, stored as int8
codes with a per-block f32 scale ``absmax / 127 + 1e-12`` (codes
``round(x / scale)`` half to even, clipped to ±127): 4× smaller optimizer
state (the flat codec of ``kernels/kv_codec.py``). Moments are
dequantized, updated in f32 and requantized every step.

Every scalar of the update is an f32 tensor on the parameters' device
(``b1 ** step``, the bias corrections, the learning rate), as JAX computes
them; divisions by a constant divide by a tensor (torch divides a tensor by
a Python scalar through its reciprocal on CUDA, one ulp off the true
division). :func:`adamw_update` updates the parameters and moments in
place, leaf by leaf (one set of launches per leaf, as the reference's
per-leaf update), like the JAX trainer's step donating its input state.
Trees are dicts (keys in sorted order, as JAX flattens them), lists and
NamedTuples; a :class:`Quantized8` is one leaf of a moment tree.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.kernels.kv_codec import dec_int8, enc_int8

Tensor = torch.Tensor
_BLOCK = 128


class Quantized8(NamedTuple):
    q: Tensor           # int8 (n_blocks, 128), the flat tensor zero-padded
    scale: Tensor       # (n_blocks,) f32 absmax / 127 + 1e-12


def _q8(x: Tensor) -> Quantized8:
    return Quantized8(*enc_int8(x, _BLOCK))


def _dq8(z: Quantized8, shape: Tuple[int, ...]) -> Tensor:
    return dec_int8(z.q, z.scale, shape)


class AdamWState(NamedTuple):
    step: Tensor        # int32 scalar
    m: Any              # tree of f32 tensors or Quantized8
    v: Any


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in the JAX package's flattening order (dict keys
    sorted); a :class:`Quantized8` is a leaf."""
    if isinstance(tree, Quantized8) or isinstance(tree, Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, in :func:`tree_leaves`' order, keeping ``tree``'s
    structure."""
    if isinstance(tree, (Quantized8, Tensor)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def adamw_init(params: Any, int8: bool = False) -> AdamWState:
    """Zero moments, f32 tensors or :class:`Quantized8` (m and v distinct
    buffers), and step 0, on the parameters' device."""
    def zero(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _q8(z) if int8 else z
    dev = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      tree_map(zero, params), tree_map(zero, params))


def state_bytes(state: AdamWState) -> int:
    """Bytes held by the moments (codes and scales under int8)."""
    n = 0
    for leaf in tree_leaves(state.m) + tree_leaves(state.v):
        for t in (leaf if isinstance(leaf, Quantized8) else (leaf,)):
            n += t.numel() * t.element_size()
    return n


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any, *,
                 lr: Tensor, tc: TrainConfig,
                 int8: bool = False) -> Tuple[Any, AdamWState]:
    """One AdamW step: ``params`` and the moment tensors of ``state`` are
    updated in place and returned with the step advanced."""
    step = state.step + 1
    b1, b2, eps, wd = tc.beta1, tc.beta2, tc.eps, tc.weight_decay
    stepf = step.float()
    one = torch.ones((), dtype=torch.float32, device=stepf.device)
    c1 = one - torch.pow(torch.full_like(stepf, b1), stepf)
    c2 = one - torch.pow(torch.full_like(stepf, b2), stepf)
    lr = lr.float()

    def upd(p, g, m, v):
        g = g.float()
        mf = _dq8(m, p.shape) if int8 else m
        vf = _dq8(v, p.shape) if int8 else v
        mf = b1 * mf + (1 - b1) * g
        vf = b2 * vf + (1 - b2) * g * g
        delta = (mf / c1) / (torch.sqrt(vf / c2) + eps) + wd * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        for old, new in ((m, mf), (v, vf)):
            if int8:
                z = _q8(new)
                old.q.copy_(z.q)
                old.scale.copy_(z.scale)
            else:
                old.copy_(new)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        upd(p, g, m, v)
    return params, AdamWState(step, state.m, state.v)


def global_norm(tree: Any) -> Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's sum of
    squares, in f32."""
    total = None
    for leaf in tree_leaves(tree):
        s = torch.sum(torch.square(leaf.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(tree: Any, max_norm: float,
                        norm: Optional[Tensor] = None) -> Tuple[Any, Tensor]:
    """The leaves scaled by ``min(1, max_norm / (‖tree‖ + 1e-9))`` (in
    f32, back to each leaf's dtype), and the norm (``norm``: the norm
    given, a sharded tree's)."""
    gn = global_norm(tree) if norm is None else norm
    factor = torch.clamp_max(torch.full_like(gn, max_norm) / (gn + 1e-9),
                             1.0)
    return tree_map(lambda g: (g.float() * factor).to(g.dtype), tree), gn
