"""Quantization-group sharding on ``torch.distributed`` (the quant-group
part of the JAX package's ``distributed/sharding.py``).

The batched executor (core/plan.py) stacks a group's L same-shape linears
into (L, Cout, Cin) slabs. Quantization is parallel over both leading
axes: lanes are independent linears, and rows are independent given the
per-lane Cholesky factor. So a slab shards its lane axis over ``data``
(or, for a group made entirely of stacked expert slabs, over ``expert``
× ``data``) and its Cout rows over ``model``.

The JAX package runs one controller that places each group on the mesh.
The port runs SPMD, one process a rank: every rank walks the same layers
on the same inputs and holds the whole stacked slabs, so
:meth:`QuantGroupSharding.local` takes this rank's block without a
scatter, and :meth:`QuantGroupSharding.gather` makes the whole tensor
again on every rank from the ranks' blocks. The collectives run on the
process groups of the mesh's dims; a lane axis over the product of two
dims gets a group of its own, built by :func:`~repro_torch.launch.mesh.
make_host_mesh` on every rank in the same order. With the gloo backend a
CUDA tensor crosses processes through a host copy (ranks that share one
card run on gloo, which takes CPU tensors); with NCCL it stays on its
card.

``Rules``, ``shard_hint`` and the param, cache, batch and train-state
shardings (training's half) are not ported (ROADMAP.md queue 1 item 17).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Tensor = torch.Tensor

_QUANT_GROUP_SPECS = {
    # kind → spec template over (lane, row, ...) tokens; a dim past the
    # template's length is replicated
    "w":       ("lane", "row", None),        # (L, Cout, Cin) weight slab
    "hessian": ("lane", None, None),         # (L, Cin, Cin) Gram/damped H
    "x":       ("lane", None, None),         # (L, n_last, Cin) instance
    "lane":    ("lane",),                    # (L,) counts / err / masks
}


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The process group of one mesh axis (or of a product of axes) as
    this rank sees it: ``size`` shards, this rank's shard ``index``, and
    ``order[i]``, the shard index of the group's i-th rank (ranks in
    ascending global order, as ``all_gather`` returns them)."""
    group: Any
    size: int
    index: int
    order: Tuple[int, ...]


# (id(mesh), axes) → (mesh, AxisGroup); the mesh is kept so that its id
# is not reused while the entry lives
_AXIS_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Tuple[Any, AxisGroup]] = {}


def _axes_of(axis) -> Tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def _mesh_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _coords(mesh) -> Dict[int, Tuple[int, ...]]:
    """Global rank → its coordinate in the mesh."""
    grid = mesh.mesh
    return {int(grid[idx]): idx
            for idx in (tuple(int(i) for i in t)
                        for t in torch.nonzero(grid >= 0))}


def _shard_index(mesh, coord: Tuple[int, ...], axes: Tuple[str, ...]
                 ) -> int:
    """Mixed-radix index over ``axes``, the first axis major (a JAX
    PartitionSpec entry of several axes splits the dim so)."""
    names = list(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    idx = 0
    for a in axes:
        d = names.index(a)
        idx = idx * sizes[d] + coord[d]
    return idx


def build_axis_groups(mesh, axes: Tuple[str, ...]) -> None:
    """Make the process groups over the product of ``axes``: one group
    for each setting of the other dims. ``dist.new_group`` is collective
    over the world, so every rank calls this for the same axes in the same
    order (``make_host_mesh`` does, for ``("expert", "data")``)."""
    names = list(mesh.mesh_dim_names)
    coords = _coords(mesh)
    others = [d for d, n in enumerate(names) if n not in axes]
    blocks: Dict[Tuple[int, ...], List[int]] = {}
    for r, c in sorted(coords.items()):
        blocks.setdefault(tuple(c[d] for d in others), []).append(r)
    me = dist.get_rank()
    mine = None
    for key in sorted(blocks):
        ranks = sorted(blocks[key])
        g = dist.new_group(ranks)
        if me in ranks:
            mine = (g, ranks)
    if mine is None:
        return
    g, ranks = mine
    order = tuple(_shard_index(mesh, coords[r], axes) for r in ranks)
    _AXIS_GROUPS[(id(mesh), axes)] = (mesh, AxisGroup(
        g, len(ranks), _shard_index(mesh, coords[me], axes), order))


def axis_group(mesh, axis) -> AxisGroup:
    """The :class:`AxisGroup` of a mesh dim name, or of a tuple of dim
    names (built beforehand by :func:`build_axis_groups`)."""
    axes = _axes_of(axis)
    hit = _AXIS_GROUPS.get((id(mesh), axes))
    if hit is not None:
        return hit[1]
    if len(axes) != 1:
        raise KeyError(f"no process group over {axes}: build_axis_groups "
                       "must run on every rank first")
    group = mesh.get_group(axes[0])
    coords = _coords(mesh)
    ranks = dist.get_process_group_ranks(group)
    order = tuple(_shard_index(mesh, coords[r], axes) for r in ranks)
    ag = AxisGroup(group, len(ranks),
                   _shard_index(mesh, coords[dist.get_rank()], axes), order)
    _AXIS_GROUPS[(id(mesh), axes)] = (mesh, ag)
    return ag


def _comm_device(group) -> torch.device:
    """Where a collective reads its tensors: the host for gloo (ranks
    sharing a card, or the CPU), the rank's card for NCCL."""
    if dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _wire(t: Tensor) -> Tensor:
    """``t`` as an integer tensor of the same bits (a broadcast moves
    bits: bfloat16 and bool need no support from the backend then)."""
    if t.dtype.is_floating_point:
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def psum(t: Tensor, group) -> Tensor:
    """The sum of ``t`` over ``group``'s ranks (a new tensor, the same on
    every rank of the group)."""
    dev = _comm_device(group)
    buf = t.to(dev, copy=True)
    dist.all_reduce(buf, group=group)
    return buf.to(t.device)


def all_gather_cat(t: Tensor, dim: int, ag: AxisGroup) -> Tensor:
    """The ranks' blocks of ``ag`` concatenated along ``dim`` in shard
    order, on every rank."""
    dev = _comm_device(ag.group)
    src = t.contiguous().to(dev)
    parts = [torch.empty_like(src) for _ in range(ag.size)]
    dist.all_gather(parts, src, group=ag.group)
    by_shard = [None] * ag.size
    for part, shard in zip(parts, ag.order):
        by_shard[shard] = part
    return torch.cat(by_shard, dim).to(t.device)


def broadcast_tree(tree, src: int = 0):
    """A copy of ``tree`` (dicts, lists and tuples of tensors) holding
    rank ``src``'s values on every rank of the world, bit for bit."""
    if isinstance(tree, dict):
        return {k: broadcast_tree(v, src) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(broadcast_tree(v, src) for v in tree)
    if not isinstance(tree, Tensor):
        return tree
    buf = tree.to(_comm_device(None), copy=True).contiguous()
    dist.broadcast(_wire(buf), src=src)
    return buf.to(tree.device)


@dataclasses.dataclass(frozen=True)
class QuantGroupSharding:
    """Resolved mesh placement for one quant group's stacked slabs.

    ``lane_axis`` is a mesh dim name, a tuple of names (an
    expert-stacked group's lanes over e.g. ``("expert", "data")``) or
    None; ``row_axis`` is ``"model"`` or None; at least one is set
    (:func:`quant_group_sharding` returns None otherwise)."""
    mesh: Any
    lane_axis: Any
    row_axis: Optional[str]

    def spec(self, kind: str) -> Tuple:
        """The JAX ``PartitionSpec`` of ``kind`` as a tuple of entries."""
        return tuple(self.lane_axis if t == "lane"
                     else self.row_axis if t == "row" else None
                     for t in _QUANT_GROUP_SPECS[kind])

    def _dims(self, kind: str):
        return [(d, axis_group(self.mesh, a))
                for d, a in enumerate(self.spec(kind)) if a is not None]

    def local(self, x: Tensor, kind: str) -> Tensor:
        """This rank's block of a whole tensor (a view)."""
        for d, ag in self._dims(kind):
            n = x.shape[d]
            if n % ag.size:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                 f"split over {ag.size} shards")
            step = n // ag.size
            x = x.narrow(d, ag.index * step, step)
        return x

    def gather(self, x: Tensor, kind: str) -> Tensor:
        """The whole tensor, on every rank, from the ranks' blocks."""
        for d, ag in reversed(self._dims(kind)):
            x = all_gather_cat(x, d, ag)
        return x

    def own(self, x: Tensor, kind: str, lanes: int,
            rows: Optional[int] = None) -> Tensor:
        """This rank's block of ``x``, which holds either the whole tensor
        (``lanes`` lanes, ``rows`` rows) or this rank's block already (a
        factor made lane-locally, a stage's unjoined output): a sharded dim
        is cut where it still has its whole size."""
        for d, ag in self._dims(kind):
            whole = lanes if d == 0 else rows
            if x.shape[d] == whole:
                step = whole // ag.size
                x = x.narrow(d, ag.index * step, step)
        return x

    def row_group(self):
        """The process group the row shards sum their partials over."""
        return axis_group(self.mesh, self.row_axis).group

    def psum_rows(self, x: Tensor) -> Tensor:
        return x if self.row_axis is None else psum(x, self.row_group())


def quant_group_sharding(mesh, lanes: int, out_dim: int,
                         expert_stacked: bool = False
                         ) -> Optional[QuantGroupSharding]:
    """Placement for a stacked (lanes, out_dim, ·) quant group, or None.

    The JAX package's guards: a lane axis only where its size divides
    ``lanes``, the row axis only where ``model`` divides ``out_dim``; a
    group failing both stays unsharded. An expert-stacked group offers its
    lanes to ``("expert", "data")``, then ``("expert",)``, then
    ``("data",)``; other groups to ``("data",)`` only. ``mesh`` needs only
    ``mesh_dim_names`` and ``shape``. On a rank outside the mesh (a world
    larger than the mesh) every group runs unsharded."""
    if mesh is None:
        return None
    sizes = _mesh_sizes(mesh)
    tp = sizes.get("model", 1)
    ep = sizes.get("expert", 1)
    if hasattr(mesh, "get_coordinate") and mesh.get_coordinate() is None:
        return None

    def _axes_fit(axes: Sequence[str]) -> bool:
        prod = 1
        for a in axes:
            prod *= sizes.get(a, 1)
        return prod > 1 and lanes % prod == 0

    lane_ax: Any = None
    candidates: List[Tuple[str, ...]] = []
    if expert_stacked and ep > 1:
        candidates += [("expert", "data"), ("expert",)]
    candidates.append(("data",))
    for cand in candidates:
        axes = tuple(a for a in cand if sizes.get(a, 1) > 1)
        if axes and _axes_fit(axes):
            lane_ax = axes[0] if len(axes) == 1 else axes
            break
    row_ax = "model" if tp > 1 and out_dim % tp == 0 else None
    if lane_ax is None and row_ax is None:
        return None
    return QuantGroupSharding(mesh, lane_ax, row_ax)
