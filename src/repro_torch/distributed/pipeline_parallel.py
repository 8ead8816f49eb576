"""GPipe pipeline parallelism over the ``pod`` axis.

The twin of the JAX package's ``distributed/pipeline_parallel.py``
(``shard_map`` + ``ppermute`` there; point-to-point sends on the ``pod``
group's ranks here):

  - the layer stack is split into ``n_stages`` contiguous stages, one per
    ``pod`` index; each rank keeps only its stage's block of the
    stage-stacked leaves;
  - a microbatch loop runs the stages in lockstep: at tick ``t`` stage
    ``s`` works on microbatch ``t − s`` (bubble ``(S−1)/(T+S−1)``);
  - boundary activations go from stage s to s+1 (``batch_isend_irecv``;
    over gloo through host copies), and the last stage's outputs, masked
    on the others, are summed to every rank.

Forward only, as the reference's. ``parallel.pipeline_stages`` and
``pp_microbatches`` are read nowhere, in the reference as here.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding
from repro_torch.training.optimizer import tree_map

Tensor = torch.Tensor


def gpipe_forward(mesh, stage_fn: Callable[[Any, Tensor], Tensor],
                  stage_params: Any, x: Tensor, *, n_microbatches: int,
                  axis: str = "pod") -> Tensor:
    """``stage_{S-1}(… stage_0(x))`` over the whole batch, on every rank.

    ``stage_params``: a tree whose every leaf has a leading (n_stages,)
    dim (this rank keeps its stage's block); ``x``: the (B, ...) global
    batch, the same on every rank, split into ``n_microbatches`` along its
    leading dim."""
    ag = sharding.axis_group(mesh, axis)
    n_stages, s = ag.size, ag.index
    if x.shape[0] % n_microbatches:
        raise ValueError(f"batch {x.shape[0]} does not split into "
                         f"{n_microbatches} microbatches")
    mine = tree_map(lambda a: sharding.local_block(
        a, sharding.PSpec(axis), mesh)[0], stage_params)
    micro = x.reshape(n_microbatches, x.shape[0] // n_microbatches,
                      *x.shape[1:])
    # the global ranks of the neighbouring stages
    by_stage = dict(zip(ag.order, dist.get_process_group_ranks(ag.group)))
    buf = torch.zeros_like(micro[0])
    outs = torch.zeros_like(micro)
    for t in range(n_microbatches + n_stages - 1):
        m_idx = t - s
        active = 0 <= m_idx < n_microbatches
        if active:
            y = stage_fn(mine, micro[m_idx] if s == 0 else buf)
            if s == n_stages - 1:
                outs[m_idx] = y
        else:
            y = torch.zeros_like(buf)
        got = sharding.send_recv(
            y, by_stage.get(s + 1), buf, by_stage.get(s - 1), ag.group)
        if got is not None:
            buf = got
    if s != n_stages - 1:
        outs = torch.zeros_like(outs)
    return sharding.psum(outs, ag.group).reshape(x.shape)


def stack_stages(layer_params_list: List[Any], n_stages: int):
    """Per-layer param trees → one tree of (n_stages, per, ...) leaves and
    ``per``, the layers a stage (they must divide evenly)."""
    n = len(layer_params_list)
    if n % n_stages:
        raise ValueError(f"{n} layers do not split into {n_stages} stages")
    per = n // n_stages
    stages = [tree_map(lambda *xs: torch.stack(xs),
                       *layer_params_list[s * per:(s + 1) * per])
              for s in range(n_stages)]
    return tree_map(lambda *xs: torch.stack(xs), *stages), per


def make_stage_fn(layer_apply: Callable[[Any, Tensor], Tensor],
                  per_stage: int):
    """``stage_fn`` applying the stage's ``per_stage`` stacked layers in
    order."""
    def stage_fn(stage_params, x):
        for i in range(per_stage):
            x = layer_apply(tree_map(lambda a: a[i], stage_params), x)
        return x

    return stage_fn
