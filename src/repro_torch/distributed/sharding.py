"""Sharding on ``torch.distributed``: the placement rules of training
(params, caches, batches and the train state), the tree twins of
``jax.device_put`` / ``device_get``, and quantization-group sharding — the
twin of the JAX package's ``distributed/sharding.py``.

The JAX package runs one controller that places arrays on a mesh and lets
GSPMD partition the step. The port runs SPMD, one process a rank: every
rank computes the same placement (:func:`param_pspecs`,
:func:`train_state_pspecs`, … return trees of :class:`PSpec`, the JAX
``PartitionSpec``'s entries), :func:`local` takes this rank's block of
each whole leaf without a scatter, and :func:`gather` makes the whole
leaves again on every rank. The collectives run on the process groups of
the mesh's dims; a spec entry over the product of two dims (the data
parallel axes ``("pod", "data")``) gets a group of its own, built by
:func:`~repro_torch.launch.mesh.make_host_mesh` on every rank in the same
order. With the gloo backend a CUDA tensor crosses processes through a
host copy (ranks that share one card run on gloo, which takes CPU
tensors); with NCCL it stays on its card; on the ``fake`` backend of the
shape-only dry run (``launch/mesh.fake_world``) it stays where it is.
:func:`comm_bytes` counts what this rank hands to the collectives, and
:func:`comm_by_kind` the same by kind, with the calls. A collective of
fake tensors is counted and makes its outputs' shapes, and calls no
backend (its values are none).

Training is explicit data parallelism (``training/train_step.
make_sharded_train_step``): each rank runs the single-device loss on its
block of the batch. So the JAX package's activation placements over the
data parallel axes (``shard_hint`` "act", "tokens", "batch1", "logits" at
``src/repro/models/transformer.py:315,346,431,437,630,664``) hold by
construction. Under :func:`use_rules` the
loss's sums over the batch (``train_step.cross_entropy``) and the routed
MoE's load-balance loss (``models/moe.moe_ffn``, the reference's local
dispatch) read :func:`current_rules` and sum over the data parallel group
with :func:`psum_local_grad`, whose backward stays on this rank: the
ranks' parameter gradients then sum to the global batch's.

The ``model`` axis splits the Megatron products as GSPMD does
(:class:`ModelSplit`, made by :func:`model_split` and set by
:func:`use_split` for the step's forward and backward): a rank runs the
one-device layers at 1/m of the heads (or of the q-heads over its one
kv-head, GQA; MLA's heads over its whole latents), of ``d_ff``, of
Mamba's ``d_inner``, of RG-LRU's ``lru_width``, of the routed experts,
of the MTP projection's columns and of the vocab, on its blocks of the
column-parallel (q/k/v, MLA's q_up / k_up / v_up, gate/up, Mamba's in /
dt / conv, RG-LRU's in / gate / conv / rg / ig, the MTP projection, the
head, the embedding's rows) and row-parallel (o, down, Mamba's x and
out, RG-LRU's out) weights. The operators are
autograd Functions on the counted collectives: :func:`copy_to_model`
(Megatron's *f*: identity, its gradient summed over ``model``) before a
column-parallel product, :func:`reduce_from_model` (*g*: the sum over
``model``, identity backward) after a row-parallel one, ``_AllReduce``
(*g* then *f*) after Mamba's x projection, which every rank reads at its
own channels, ``_Reblock`` (an :func:`exchange`, all-to-all) from the
stored [u | z] block of Mamba's in projection to the rank's columns,
``ModelSplit.gather_channels`` (RG-LRU's input of rg / ig, the MTP
projection's output, all-gathered over the last dim) and
for ``parallel.sp`` :func:`gather_seq` / :func:`scatter_seq`, the
residual's sequence over ``model`` (``shard_hint`` "act" with ``sp``).

The rules and the plan are held for the process, not for a thread:
autograd runs a CUDA tensor's backward on a thread of its own, and under
remat the super-block's forward is recomputed there, reading both.

Quantization groups: the batched executor (core/plan.py) stacks a group's
L same-shape linears into (L, Cout, Cin) slabs. Quantization is parallel
over both leading axes: lanes are independent linears, and rows are
independent given the per-lane Cholesky factor. So a slab shards its lane
axis over ``data`` (or, for a group made entirely of stacked expert slabs,
over ``expert`` × ``data``) and its Cout rows over ``model``
(:class:`QuantGroupSharding`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import types
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor

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


def _comm_device(group, like: Optional[Tensor] = None) -> torch.device:
    """Where a collective reads its tensors: the host for gloo (ranks
    sharing a card, or the CPU), the rank's card for NCCL, on the fake
    backend ``like``'s own device (the host for none)."""
    backend = dist.get_backend(group)
    if backend == "gloo" or (backend == "fake" and like is None):
        return torch.device("cpu")
    if backend == "fake":
        return like.device
    return torch.device("cuda", torch.cuda.current_device())


def _wire(t: Tensor) -> Tensor:
    """``t`` as an integer tensor of the same bits (a broadcast moves
    bits: bfloat16 and bool need no support from the backend then)."""
    if t.dtype.is_floating_point:
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    return t.view(torch.uint8) if t.dtype == torch.bool else t


# bytes this process handed to the collectives below (each input once),
# and by kind (the JAX dry run's names where one carries over) the calls,
# those bytes and a ring's estimate of the bytes a rank's links carry
_COMM_BYTES = [0]
_COMM_KINDS: Dict[str, List[float]] = {}


def _count(kind: str, t: Tensor, ranks: int) -> None:
    """Count a collective of ``t`` over ``ranks`` ranks. A rank's link
    bytes, as the JAX dry run reckons a ring: all-gather S·(g−1),
    all-reduce 2·S·(g−1)/g, broadcast S·(g−1)/g, a point-to-point send
    S."""
    n = t.numel() * t.element_size()
    _COMM_BYTES[0] += n
    g = max(1, ranks)
    link = {"all-gather": n * (g - 1), "all-reduce": 2 * n * (g - 1) / g,
            "broadcast": n * (g - 1) / g}.get(kind, n)
    c = _COMM_KINDS.setdefault(kind, [0, 0, 0.0])
    c[0] += 1
    c[1] += n
    c[2] += link


def comm_bytes() -> int:
    """Bytes this rank has handed to :func:`psum`, :func:`all_gather_cat`,
    :func:`broadcast_tree`, :func:`send_recv` and :func:`exchange` since
    the last reset."""
    return _COMM_BYTES[0]


def comm_by_kind() -> Dict[str, Dict[str, float]]:
    """``{kind: {"count", "bytes", "link_bytes"}}`` since the last reset:
    ``all-reduce`` (:func:`psum`), ``all-gather`` (:func:`all_gather_cat`),
    ``broadcast`` (:func:`broadcast_tree`), ``collective-permute``
    (:func:`send_recv`), ``all-to-all`` (:func:`exchange`); :func:`pmax`
    and :func:`reduce_scatter` count as all-reduces; ``link_bytes`` a
    ring's estimate (``_count``; an all-to-all's, the bytes it sends to
    other ranks)."""
    return {k: {"count": int(c), "bytes": int(n), "link_bytes": link}
            for k, (c, n, link) in _COMM_KINDS.items()}


def reset_comm_bytes() -> None:
    _COMM_BYTES[0] = 0
    _COMM_KINDS.clear()


def psum(t: Tensor, group) -> Tensor:
    """The sum of ``t`` over ``group``'s ranks (a new tensor, the same on
    every rank of the group)."""
    buf = t.to(_comm_device(group, t), copy=True)
    _count("all-reduce", buf, dist.get_world_size(group))
    if not isinstance(buf, FakeTensor):
        dist.all_reduce(buf, group=group)
    return buf.to(t.device)


def psum_tree(tree, group):
    """:func:`psum` of every leaf of a tree of tensors, one collective a
    dtype (the leaves joined into one flat buffer)."""
    from repro_torch.training.optimizer import tree_leaves, tree_map
    leaves = tree_leaves(tree)
    out: List[Optional[Tensor]] = [None] * len(leaves)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = psum(torch.cat([leaves[i].reshape(-1) for i in idx]), group)
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[off:off + n].view(leaves[i].shape)
            off += n
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


class _SumLocalGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def pmax(t: Tensor, group) -> Tensor:
    """The elementwise maximum of ``t`` over ``group``'s ranks (no
    gradient), counted as an all-reduce."""
    buf = t.detach().to(_comm_device(group, t), copy=True)
    _count("all-reduce", buf, dist.get_world_size(group))
    if not isinstance(buf, FakeTensor):
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    return buf.to(t.device)


def reduce_scatter(t: Tensor, dim: int, ag: AxisGroup) -> Tensor:
    """The sum of ``t`` over ``ag``'s ranks, this rank's block of it along
    ``dim`` (shard order): a :func:`psum` and a cut, counted as the
    all-reduce it is (the same bits on every rank, whatever gloo's
    version takes; a reduce-scatter waits for a run on cards of their
    own)."""
    n = t.shape[dim] // ag.size
    return psum(t, ag.group).narrow(dim, ag.index * n, n)


def psum_local_grad(x: Tensor, group) -> Tensor:
    """:func:`psum` whose backward reaches this rank's ``x`` only: where
    every rank goes on to the same loss, the ranks' parameter gradients
    sum to the gradient of the loss of the summed terms (the data parallel
    reduction of a batch-summed quantity)."""
    return _SumLocalGrad.apply(x, group)


def all_gather_cat(t: Tensor, dim: int, ag: AxisGroup) -> Tensor:
    """The ranks' blocks of ``ag`` concatenated along ``dim`` in shard
    order, on every rank."""
    src = t.contiguous().to(_comm_device(ag.group, t))
    _count("all-gather", src, ag.size)
    parts = [torch.empty_like(src) for _ in range(ag.size)]
    if not isinstance(src, FakeTensor):
        dist.all_gather(parts, src, group=ag.group)
    by_shard = [None] * ag.size
    for part, shard in zip(parts, ag.order):
        by_shard[shard] = part
    return torch.cat(by_shard, dim).to(t.device)


def exchange(sends: Dict[int, Tensor], recv_from: Sequence[int],
             like: Tensor, ag: AxisGroup) -> Dict[int, Tensor]:
    """One all-to-all over ``ag``: ``sends[s]`` goes to the rank of shard
    ``s`` and this rank receives one tensor shaped like ``like`` from the
    rank of each shard in ``recv_from`` (returned by shard). Counted as
    ``all-to-all``, its link bytes those sent to other ranks."""
    dev = _comm_device(ag.group, like)
    by_pos = {shard: i for i, shard in enumerate(ag.order)}
    pos_send = {by_pos[s]: t for s, t in sends.items()}
    pos_recv = sorted(by_pos[s] for s in recv_from)
    n = like.numel()
    src = torch.cat([pos_send[i].reshape(-1).to(dev) for i in sorted(
        pos_send)]) if pos_send else like.new_empty((0,), device=dev)
    out = torch.empty((n * len(pos_recv),), dtype=like.dtype, device=dev)
    nbytes = src.numel() * src.element_size()
    _COMM_BYTES[0] += nbytes
    c = _COMM_KINDS.setdefault("all-to-all", [0, 0, 0.0])
    c[0] += 1
    c[1] += nbytes
    c[2] += sum(t.numel() * t.element_size() for s, t in sends.items()
                if s != ag.index)
    if not isinstance(src, FakeTensor):
        dist.all_to_all_single(
            _wire(out), _wire(src), [n if i in pos_recv else 0 for i in range(ag.size)],
            [pos_send[i].numel() if i in pos_send else 0
             for i in range(ag.size)], group=ag.group)
    got = out.view(len(pos_recv), *like.shape).to(like.device)
    return {ag.order[i]: got[j] for j, i in enumerate(pos_recv)}


def any_rank(flag: bool, group=None) -> bool:
    """True on every rank of ``group`` (default: the world) when any
    rank's ``flag`` is."""
    t = torch.tensor([int(flag)], device=_comm_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def send_recv(t: Optional[Tensor], dst: Optional[int], like: Tensor,
              src: Optional[int], group) -> Optional[Tensor]:
    """Send ``t`` to global rank ``dst`` while receiving a tensor shaped
    like ``like`` from global rank ``src`` (either side may be None);
    returns what was received, on ``like``'s device, or None."""
    dev = _comm_device(group, like)
    ops: List[dist.P2POp] = []
    if dst is not None:
        buf = t.to(dev, copy=True).contiguous()
        _count("collective-permute", buf, 2)
        ops.append(dist.P2POp(dist.isend, buf, dst, group))
    got = None
    if src is not None:
        got = torch.empty(like.shape, dtype=like.dtype, device=dev)
        ops.append(dist.P2POp(dist.irecv, got, src, group))
    if ops and not isinstance(like, FakeTensor):
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return None if got is None else got.to(like.device)


def broadcast_tree(tree, src: int = 0):
    """A copy of ``tree`` (dicts, lists and tuples of tensors) holding
    rank ``src``'s values on every rank of the world, bit for bit."""
    if isinstance(tree, dict):
        return {k: broadcast_tree(v, src) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(broadcast_tree(v, src) for v in tree)
    if not isinstance(tree, Tensor):
        return tree
    buf = tree.to(_comm_device(None, tree), copy=True).contiguous()
    _count("broadcast", buf, dist.get_world_size())
    if not isinstance(buf, FakeTensor):
        dist.broadcast(_wire(buf), src=src)
    return buf.to(tree.device)


# ---------------------------------------------------------------------------
# Blocks of a spec: the twins of jax.device_put / device_get
# ---------------------------------------------------------------------------

class PSpec(tuple):
    """A JAX ``PartitionSpec``'s entries, a leaf of a spec tree: per dim
    None, a mesh dim name, or a tuple of names (split over their product,
    the first major); a one-name tuple is the name, as JAX canonicalises
    it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))


def _spec_dims(spec, mesh) -> List[Tuple[int, AxisGroup]]:
    return [(d, axis_group(mesh, a)) for d, a in enumerate(spec)
            if a is not None]


def local_block(x: Tensor, spec, mesh) -> Tensor:
    """This rank's block of a whole tensor under ``spec`` (a view)."""
    for d, ag in _spec_dims(spec, mesh):
        n = x.shape[d]
        if n % ag.size:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                             f"split over {ag.size} shards")
        step = n // ag.size
        x = x.narrow(d, ag.index * step, step)
    return x


def gather_block(x: Tensor, spec, mesh) -> Tensor:
    """The whole tensor under ``spec``, on every rank, from the ranks'
    blocks."""
    for d, ag in reversed(_spec_dims(spec, mesh)):
        x = all_gather_cat(x, d, ag)
    return x


def _map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a value tree and its spec tree (a
    ``Quantized8`` moment's codes and scales each with their own spec)."""
    from repro_torch.training.optimizer import Quantized8, tree_map

    def one(leaf, spec):
        if isinstance(leaf, Quantized8):
            return Quantized8(*(fn(a, s) for a, s in zip(leaf, spec)))
        return fn(leaf, spec)
    return tree_map(one, tree, specs)


def local(tree, specs, mesh):
    """This rank's block of each whole leaf (views): the twin of
    ``jax.device_put(tree, shardings)``."""
    return _map_specs(lambda x, s: local_block(x, s, mesh), tree, specs)


def gather(tree, specs, mesh):
    """The whole leaves on every rank from the ranks' blocks: the twin of
    ``jax.device_get`` of a sharded tree (collective over the world)."""
    return _map_specs(lambda x, s: gather_block(x, s, mesh), tree, specs)


# ---------------------------------------------------------------------------
# The placement rules (training)
# ---------------------------------------------------------------------------

# the rules (:func:`use_rules`) and the model split (:func:`use_split`) the
# layers read; for the process (module docstring)
_STATE = types.SimpleNamespace(rules=None, split=None)


@dataclasses.dataclass
class Rules:
    """The mesh's roles: batch dims over ``dp_axes`` (``("pod", "data")``
    or ``("data",)``), Megatron and expert dims over ``tp_axis``;
    ``mesh`` needs ``mesh_dim_names`` and ``shape`` (a ``DeviceMesh`` for
    :meth:`dp_group`)."""
    mesh: Any
    dp_axes: Tuple[str, ...]
    tp_axis: Optional[str] = "model"
    sp: bool = False                    # the residual's sequence over TP
    ep_local_dispatch: bool = True      # MoE routing local to a data shard

    def axis_size(self, name: Optional[str]) -> int:
        if name is None:
            return 1
        return int(_mesh_sizes(self.mesh)[name])

    def dp_size(self) -> int:
        out = 1
        for a in self.dp_axes:
            out *= self.axis_size(a)
        return out

    def dp_group(self) -> AxisGroup:
        """The process group of this rank's data parallel block."""
        return axis_group(self.mesh, tuple(self.dp_axes))


def current_rules() -> Optional[Rules]:
    return _STATE.rules


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    prev = _STATE.rules
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


def make_rules(mesh, parallel=None) -> Rules:
    names = tuple(mesh.mesh_dim_names)
    dp = tuple(a for a in ("pod", "data") if a in names)
    tp = "model" if "model" in names else None
    sp = bool(parallel.sp) if parallel is not None else False
    epl = bool(parallel.ep_local_dispatch) if parallel is not None else True
    return Rules(mesh=mesh, dp_axes=dp, tp_axis=tp, sp=sp,
                 ep_local_dispatch=epl)


def _guard(spec_entry, dim: int, rules: Rules):
    """Drop a sharding axis when the dim doesn't divide it."""
    if spec_entry is None:
        return None
    axes = spec_entry if isinstance(spec_entry, tuple) else (spec_entry,)
    size = 1
    for a in axes:
        size *= rules.axis_size(a)
    if size <= 1 or dim % size != 0:
        return None
    return spec_entry


# (regex on the '/'-joined path, spec template for the *trailing* dims):
# "tp" the model axis, "fsdp" the data axis (the reference's table)
_PARAM_RULES: List[Tuple[str, Tuple]] = [
    # embeddings / head
    (r"embed/embedding$",              ("tp", "fsdp")),
    (r"lm_head/w$",                    ("fsdp", "tp")),
    # attention projections (col-parallel q/k/v, row-parallel o)
    (r"(mixer|xattn)/(q|k|v)/w$",      ("fsdp", "tp")),
    (r"(mixer|xattn)/o/w$",            ("tp", "fsdp")),
    (r"(mixer|xattn)/(q|k|v)/b$",      ("tp",)),
    (r"(mixer|xattn)/o/b$",            (None,)),
    # MLA
    (r"mixer/(q_down|kv_down|k_rope)/w$", ("fsdp", None)),
    (r"mixer/(q_up|k_up|v_up)/w$",     ("fsdp", "tp")),
    # gated MLP
    (r"mlp/(gate|up)/w$",              ("fsdp", "tp")),
    (r"mlp/down/w$",                   ("tp", "fsdp")),
    (r"mlp/(gate|up)/b$",              ("tp",)),
    (r"mlp/down/b$",                   (None,)),
    # MoE (stacked experts, EP over model)
    (r"mlp/router/w$",                 (None, None)),
    (r"mlp/w_(gate|up)$",              ("tp", "fsdp", None)),
    (r"mlp/w_down$",                   ("tp", None, "fsdp")),
    (r"mlp/shared/(gate|up)/w$",       ("fsdp", "tp")),
    (r"mlp/shared/down/w$",            ("tp", "fsdp")),
    # mamba
    (r"mixer/in/w$",                   ("fsdp", "tp")),
    (r"mixer/x/w$",                    ("tp", None)),
    (r"mixer/dt/w$",                   (None, "tp")),
    (r"mixer/dt/b$",                   ("tp",)),
    (r"mixer/out/w$",                  ("tp", "fsdp")),
    (r"mixer/conv/w$",                 (None, "tp")),
    (r"mixer/conv/b$",                 ("tp",)),
    (r"mixer/a_log$",                  ("tp", None)),
    (r"mixer/d_skip$",                 ("tp",)),
    # rg-lru
    (r"mixer/(gate)/w$",               ("fsdp", "tp")),
    (r"mixer/(rg|ig)/w$",              (None, "tp")),
    (r"mixer/(rg|ig)/b$",              ("tp",)),
    (r"mixer/lambda$",                 ("tp",)),
    # mtp
    (r"mtp/proj/w$",                   ("fsdp", "tp")),
    # int4-packed serving leaves (QuantizedTensor children /0 /1 /2,
    # (out, in·)-major: col-parallel puts `out` on tp, row-parallel `in`)
    (r"(mixer|xattn)/(q|k|v|q_up|k_up|v_up)/w/\d$", ("tp", "fsdp")),
    (r"(mixer|xattn)/o/w/\d$",         ("fsdp", "tp")),
    (r"mixer/(q_down|kv_down|k_rope)/w/\d$", (None, "fsdp")),
    (r"mlp/(gate|up)/w/\d$",           ("tp", "fsdp")),
    (r"mlp/down/w/\d$",                ("fsdp", "tp")),
    (r"mlp/shared/(gate|up)/w/\d$",    ("tp", "fsdp")),
    (r"mlp/shared/down/w/\d$",         ("fsdp", "tp")),
    (r"mlp/w_(gate|up|down)/\d$",      ("tp", None, "fsdp")),  # (E, out, in·)
    (r"mixer/(in|gate|rg|ig)/w/\d$",   ("tp", "fsdp")),
    (r"mixer/x/w/\d$",                 (None, "tp")),
    (r"mixer/dt/w/\d$",                ("tp", None)),
    (r"mixer/out/w/\d$",               ("fsdp", "tp")),
    (r"lm_head/w/\d$",                 ("tp", "fsdp")),
]


def _has_fsdp(rules: Rules, fsdp: bool) -> bool:
    return fsdp and "data" in tuple(rules.mesh.mesh_dim_names)


def _resolve(template: Tuple, shape: Tuple[int, ...], rules: Rules,
             fsdp: bool) -> PSpec:
    """The template applies to the trailing dims; leading (stack) dims
    get None."""
    ndim = len(shape)
    t = template[-ndim:] if len(template) >= ndim else template
    lead = ndim - len(t)
    entries: List = [None] * lead
    for dim, tok in zip(shape[lead:], t):
        if tok == "tp":
            entries.append(_guard(rules.tp_axis, dim, rules))
        elif tok == "fsdp":
            entries.append(_guard("data", dim, rules)
                           if _has_fsdp(rules, fsdp) else None)
        else:
            entries.append(None)
    return PSpec(*entries)


def param_pspecs(params: Any, rules: Rules, fsdp: bool = True) -> Any:
    """The spec tree of ``params`` (a tree of tensors, paths as the JAX
    package names them): the first rule whose pattern the path matches,
    else small leaves replicated and the last ``data``-divisible dim of a
    2-D+ leaf over ``data`` under ``fsdp``."""
    from repro_torch.distributed.checkpoint import map_with_path

    def assign(path, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return PSpec()
        for pat, template in _PARAM_RULES:
            if re.search(pat, path):
                return _resolve(template, shape, rules, fsdp)
        if fsdp and len(shape) >= 2:
            ent: List = [None] * len(shape)
            for i in range(len(shape) - 1, -1, -1):
                if _guard("data", shape[i], rules) is not None:
                    ent[i] = "data"
                    break
            return PSpec(*ent)
        return PSpec(*([None] * len(shape)))

    return map_with_path(params, assign)


def cache_pspecs(caches: Any, rules: Rules) -> Any:
    """KV and state caches: batch over the data parallel axes, kv-heads
    over ``model`` where they divide, else the sequence (leading segment
    stack dims replicated):
      k/v:   (..., B, S, KV, hd) → (None.., dp, None, tp, None)
      ckv:   (..., B, S, rank)   → (None.., dp, None, None)
      conv:  (..., B, K-1, C)    → (None.., dp, None, tp)
      h:     (..., B, W[, n])    → (None.., dp, tp[, None])
    """
    from repro_torch.distributed.checkpoint import map_with_path
    dp = tuple(rules.dp_axes) if rules.dp_axes else None

    def assign(s, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        ent: List = [None] * nd
        if re.search(r"(^|/)(k|v)$", s) and nd >= 4:
            b, sq, kv, _ = shape[-4:]
            ent[-4] = _guard(dp, b, rules)
            ent[-2] = _guard(rules.tp_axis, kv, rules)
            if ent[-2] is None:
                # kv heads that do not divide: the sequence instead
                ent[-3] = _guard(rules.tp_axis, sq, rules)
        elif re.search(r"(ckv|krope)$", s) and nd >= 3:
            ent[-3] = _guard(dp, shape[-3], rules)
        elif re.search(r"conv$", s) and nd >= 3:
            ent[-3] = _guard(dp, shape[-3], rules)
            ent[-1] = _guard(rules.tp_axis, shape[-1], rules)
        elif re.search(r"(^|/)h$", s) and nd >= 2:
            # mamba h: (B, d_inner, n); rglru h: (B, W)
            if nd >= 3:
                ent[-3] = _guard(dp, shape[-3], rules)
                ent[-2] = _guard(rules.tp_axis, shape[-2], rules)
            else:
                ent[-2] = _guard(dp, shape[-2], rules)
                ent[-1] = _guard(rules.tp_axis, shape[-1], rules)
        return PSpec(*ent)

    return map_with_path(caches, assign)


def batch_pspecs(batch: Any, rules: Rules) -> Any:
    """Each batch leaf's leading dim over the data parallel axes where it
    divides them."""
    from repro_torch.distributed.checkpoint import map_with_path
    dp = tuple(rules.dp_axes) if rules.dp_axes else None

    def assign(_, leaf):
        ent: List = [None] * leaf.dim()
        if ent:
            ent[0] = _guard(dp, leaf.shape[0], rules)
        return PSpec(*ent)

    return map_with_path(batch, assign)


def train_state_pspecs(state: Any, rules: Rules, fsdp: bool = True) -> Any:
    """The spec tree of a ``TrainState`` (params, AdamW moments, steps).

    f32 moments mirror the param specs. int8 moments follow the
    reference's rule as it runs: a ``Quantized8`` child's path ends in
    ``/.q`` / ``/.scale``, never ``/q`` / ``/scale``, so only the leaves of
    at most one dim, the (n_blocks,) scales, shard their block dim over
    ``data`` (under ``fsdp``, where it divides); the (n_blocks, 128) codes
    are replicated."""
    from repro_torch.distributed.checkpoint import map_with_path
    from repro_torch.training.optimizer import (AdamWState, Quantized8,
                                                tree_leaves, tree_map)
    from repro_torch.training.train_step import TrainState

    pspecs = param_pspecs(state.params, rules, fsdp)

    def moment_spec(path, leaf):
        shape = tuple(leaf.shape)
        if path.endswith("/q") or path.endswith("/scale") or len(shape) <= 1:
            ent: List = [None] * len(shape)
            if shape and fsdp:
                ent[0] = _guard("data", shape[0], rules)
            return PSpec(*ent)
        return PSpec(*([None] * len(shape)))

    if any(isinstance(m, Quantized8) for m in tree_leaves(state.opt.m)):
        m_specs = map_with_path(state.opt.m, moment_spec)
        v_specs = map_with_path(state.opt.v, moment_spec)
    else:
        def mirror(leaf, ps):
            if len(ps) == leaf.dim():
                return ps
            return PSpec(*([None] * leaf.dim()))
        m_specs = tree_map(mirror, state.opt.m, pspecs)
        v_specs = tree_map(mirror, state.opt.v, pspecs)
    return TrainState(pspecs, AdamWState(PSpec(), m_specs, v_specs), PSpec())


# ---------------------------------------------------------------------------
# The model axis's compute split (Megatron) and parallel.sp
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Megatron's *f* over several tensors: identity forward, the
    gradients summed over the group in one collective backward."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = psum(torch.cat([g.reshape(-1) for g in gs]), ctx.group)
        out, off = [], 0
        for g in gs:
            out.append(flat[off:off + g.numel()].view(g.shape))
            off += g.numel()
        return (None, *out)


def copy_to_model(x: Tensor, group) -> Tensor:
    """Identity forward, the gradient summed over ``group`` backward
    (Megatron's *f*): the input of a column-parallel product, each rank's
    gradient of it a partial over its columns."""
    return _CopyToModel.apply(group, x)[0]


def copy_all_to_model(group, *xs: Tensor) -> Tuple[Tensor, ...]:
    """:func:`copy_to_model` of several tensors, their gradients summed in
    one collective."""
    return _CopyToModel.apply(group, *xs)


def reduce_from_model(x: Tensor, group) -> Tensor:
    """The sum over ``group`` forward, identity backward (Megatron's *g*):
    the output of a row-parallel product, or a vocab-parallel term of a
    loss every rank of the group computes alike."""
    return psum_local_grad(x, group)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ag, summed):
        ctx.dim, ctx.ag, ctx.summed, ctx.n = dim, ag, summed, x.shape[dim]
        return all_gather_cat(x, dim, ag)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return reduce_scatter(g, ctx.dim, ctx.ag), None, None, None
        return (g.narrow(ctx.dim, ctx.ag.index * ctx.n, ctx.n).contiguous(),
                None, None, None)


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ag, summed):
        ctx.dim, ctx.ag = dim, ag
        if summed:
            return reduce_scatter(x, dim, ag)
        n = x.shape[dim] // ag.size
        return x.narrow(dim, ag.index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.dim, ctx.ag), None, None, None


def gather_seq(x: Tensor, ag: AxisGroup, summed: bool = True) -> Tensor:
    """The whole sequence (dim 1) from the ranks' blocks (all-gather
    forward). Backward: the gradient's sum over the ranks, this rank's
    block of it
    (reduce-scatter), where each rank's product makes a partial of it
    (``summed``); else this rank's block of a gradient every rank holds
    whole (the input of a product every rank computes whole)."""
    return _GatherSeq.apply(x, 1, ag, summed)


def scatter_seq(x: Tensor, ag: AxisGroup, summed: bool = True) -> Tensor:
    """This rank's block of the sequence (dim 1) of the ranks' partials'
    sum (reduce-scatter forward; ``summed`` False: of a tensor every rank
    holds whole, a cut); the gradient's blocks gathered backward."""
    return _ScatterSeq.apply(x, 1, ag, summed)


# which leaves a layer kind's split computes at 1/m (paths as
# ``checkpoint.tree_paths`` names them; a row-parallel bias is replicated
# and stays whole; under ``gqa`` the k / v leaves are gathered whole and
# each rank reads its kv-head's columns; deepseek's MTP layer follows the
# main layers' kinds, its ``proj`` is ``mtp``'s)
_SPLIT_LEAVES = {
    "attn": r"(mixer|xattn)/(q|k|v|o)/w$|(mixer|xattn)/(q|k|v)/b$",
    "gqa": r"mixer/(q|o)/w$|mixer/q/b$",
    "mlp": r"mlp/(gate|up|down)/w$|mlp/(gate|up)/b$",
    "vocab": r"^(embed/embedding|lm_head/w)$",
    "mamba": (r"mixer/(in|x|dt|out|conv)/w$|mixer/(dt|conv)/b$"
              r"|mixer/(a_log|d_skip)$"),
    "experts": r"mlp/w_(gate|up|down)$|mlp/shared/(gate|up|down)/w$",
    "rglru": (r"mixer/(in|gate|rg|ig|out)/w$|mixer/conv/(w|b)$"
              r"|mixer/(rg|ig)/b$|mixer/lambda$"),
    "mla": r"mixer/(q_up|k_up|v_up|o)/w$",
    "mtp": r"^mtp/proj/w$",
}


class _AllReduce(torch.autograd.Function):
    """The sum over the group forward and backward (Megatron's *g*
    followed by *f*): a row-parallel product's output that every rank
    reads at its own columns downstream, so that each rank's gradient of
    it is a partial too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.group), None


class _Reblock(torch.autograd.Function):
    """A [u | z] column-parallel weight from its stored ``model`` block to
    the rank's [u_r | z_r] (one all-to-all over the axis), and its
    gradient back (the inverse all-to-all).

    Of the 2m column chunks of d/m (d the width of u and of z), the
    stored block of shard q holds chunks 2q and 2q + 1; chunk c is u_c
    (c < m) or z_(c-m), so it goes to shard c mod m."""

    @staticmethod
    def forward(ctx, w, ag):
        ctx.ag = ag
        m, q = ag.size, ag.index
        half = w.shape[-1] // 2
        pieces = {}
        for j in range(2):
            pieces[(2 * q + j) % m] = w[..., j * half:(j + 1) * half]
        src = (q // 2, (m + q) // 2)        # the holders of u_q and z_q
        got = exchange(pieces, src, pieces[(2 * q) % m], ag)
        return torch.cat([got[src[0]], got[src[1]]], dim=-1)

    @staticmethod
    def backward(ctx, g):
        ag = ctx.ag
        m, q = ag.size, ag.index
        half = g.shape[-1] // 2
        back = {q // 2: g[..., :half], (m + q) // 2: g[..., half:]}
        dst = ((2 * q) % m, (2 * q + 1) % m)
        got = exchange(back, dst, back[q // 2], ag)
        return torch.cat([got[dst[0]], got[dst[1]]], dim=-1), None


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """What the ranks of one ``model`` group compute split, the same on
    every rank (:func:`model_split`): self- and cross-attention by heads
    (``attn``), or, where the kv-heads do not divide the axis but the
    axis is a multiple of them, self-attention by q-heads with each rank
    reading its one kv-head (``gqa``); the dense MLP by ``d_ff``
    (``mlp``); the embedding and the head by vocab (``vocab``); Mamba by
    its ``d_inner`` channels (``mamba``); routed experts by their E axis
    (``experts``; the routing whole on every rank); RG-LRU by its
    ``lru_width`` channels (``rglru``); MLA by heads (``mla``; its
    latents whole on every rank); deepseek's MTP projection by its
    ``d_model`` output columns (``mtp``; the MTP layer follows the main
    layers' flags). ``cfg`` is the layers' local ModelConfig (a rank's
    heads and kv-heads, ``d_ff``, ``d_inner``, experts and ``lru_width``);
    ``kv_heads`` the whole model's kv-heads. With ``sp`` a residual whose
    sequence divides the axis is sequence-sharded over it
    (:meth:`seq_split`)."""
    ag: AxisGroup
    cfg: Any
    attn: bool
    mlp: bool
    vocab: bool
    sp: bool
    tp_axis: str = "model"
    gqa: bool = False
    mamba: bool = False
    experts: bool = False
    kv_heads: int = 0
    rglru: bool = False
    mla: bool = False
    mtp: bool = False

    @property
    def index(self) -> int:
        return self.ag.index

    def seq_split(self, seq_len: int) -> bool:
        """True where a residual of ``seq_len`` positions is sharded over
        the axis (JAX's ``_guard(seq, x.shape[1])``)."""
        return self.sp and seq_len % self.ag.size == 0

    def splits(self, path: str) -> bool:
        """True for a leaf the plan computes at its ``model`` block."""
        return any(getattr(self, kind) and re.search(pat, path)
                   for kind, pat in _SPLIT_LEAVES.items())

    def enter(self, x: Tensor, split: bool, seq: bool) -> Tensor:
        """A product's input from the residual side: for a split product
        :func:`copy_to_model`, or the sequence gathered with a summed
        gradient (``seq``: x is this rank's block of it); for a product
        every rank computes whole, x itself or the sequence gathered."""
        if seq:
            return gather_seq(x, self.ag, summed=split)
        return copy_to_model(x, self.ag.group) if split else x

    def leave(self, y: Tensor, seq: bool) -> Tensor:
        """A whole product's output back to the residual: this rank's
        block of the sequence where it is sharded."""
        return scatter_seq(y, self.ag, summed=False) if seq else y

    def row_reduce(self, seq: bool):
        """The sum of a row-parallel product's fp32 partials (``dense``'s
        ``reduce``): over the axis, or reduce-scattered over the
        sequence."""
        if seq:
            return lambda y: scatter_seq(y, self.ag)
        return lambda y: reduce_from_model(y, self.ag.group)

    def gather_channels(self, x: Tensor, summed: bool = True) -> Tensor:
        """The ranks' blocks of the last dim concatenated (all-gather
        forward). Backward: this rank's block of the gradient's sum over
        the ranks (reduce-scatter; ``summed``: each rank's product makes
        a partial of it, RG-LRU's gathered input of ``rg`` / ``ig``), or
        of a gradient every rank holds whole (a cut: the MTP
        projection's output, read whole by every rank)."""
        return _GatherSeq.apply(x, -1, self.ag, summed)

    def copy_all(self, *xs: Tensor) -> Tuple[Tensor, ...]:
        """:func:`copy_all_to_model` over the axis: inputs every rank
        holds whole whose gradients are partials over its share (MLA's
        latents, read by the rank's heads)."""
        return copy_all_to_model(self.ag.group, *xs)

    def all_reduce(self, y: Tensor) -> Tensor:
        """The sum of a row-parallel product's fp32 partials that every
        rank reads at its own columns downstream (Mamba's x projection):
        an all-reduce forward and backward."""
        return _AllReduce.apply(y, self.ag.group)

    def partial(self, p: Dict[str, Tensor], seq: bool) -> Dict[str, Tensor]:
        """A replicated leaf dict (a norm's, a row-parallel bias's) as
        used on this rank's block of the sequence: its gradient, a partial
        over the blocks, summed over the axis (one collective)."""
        if not seq:
            return p
        keys = [k for k, v in p.items() if isinstance(v, Tensor)]
        outs = copy_all_to_model(self.ag.group, *(p[k] for k in keys))
        return dict(p, **dict(zip(keys, outs)))

    def row_params(self, p: Dict, seq: bool) -> Dict:
        """A mixer's or MLP's params with the row-parallel product's bias
        (``o``, ``down``) made :meth:`partial` where the sequence is
        sharded: it is added after the reduce-scatter."""
        if not seq:
            return p
        return {k: (dict(v, **self.partial({"b": v["b"]}, seq))
                    if k in ("o", "down") and isinstance(v, dict)
                    and "b" in v else v)
                for k, v in p.items()}

    def kv_share(self, p: Dict) -> Dict:
        """A ``gqa`` mixer's params with k and v (weights and biases,
        gathered whole) cut to this rank's kv-head, ``index · kv // m``.
        Several ranks read one kv-head, so each rank's gradient of the
        whole leaf is a partial, zero outside its kv-head's columns: the
        whole leaves enter through :func:`copy_to_model` before the cut,
        which sums them (one collective)."""
        keys = [(n, k) for n in ("k", "v") for k in ("w", "b")
                if p[n].get(k) is not None]
        whole = copy_all_to_model(self.ag.group,
                                  *(p[n][k] for n, k in keys))
        hd = self.cfg.head_dim
        c0 = self.index * self.kv_heads // self.ag.size * hd
        out = {n: dict(p[n]) for n in ("k", "v")}
        for (n, k), t in zip(keys, whole):
            out[n][k] = t[..., c0:c0 + hd]
        return dict(p, **out)

    def mamba_params(self, p: Dict) -> Dict:
        """A Mamba mixer's params at this rank's channels: the stored
        ``model`` block of ``in`` (the rule ``(fsdp, tp)`` cuts [u | z]
        into contiguous blocks) re-blocked into [u_r | z_r]
        (:class:`_Reblock`); every other leaf is its block already."""
        return dict(p, **{"in": dict(p["in"], w=_Reblock.apply(
            p["in"]["w"], self.ag))})


def model_split(mc, rules: Rules) -> Optional[ModelSplit]:
    """The plan of a ModelConfig on ``rules``' mesh, or None where the
    ``model`` axis is absent or of one rank (m its size): attention split
    where both ``num_heads`` and ``num_kv_heads`` divide the axis, or
    (``gqa``) where ``num_heads`` does, ``num_kv_heads`` does not and m
    is a multiple of it (not MLA; rank r keeps q-heads ``[r·H/m,
    (r+1)·H/m)``, all reading kv-head ``r·kv // m``); MLA where
    ``num_heads`` divides it; the dense MLP where ``d_ff`` divides the
    axis, the embedding and the head where the vocab does, Mamba where
    ``d_inner`` does, routed experts where E does (and a shared expert's
    width), RG-LRU where ``lru_width`` does, the MTP projection where
    ``d_model`` does; every other leaf is gathered and computed whole.
    ``sp`` as ``rules.sp``."""
    tp = rules.tp_axis
    m = rules.axis_size(tp)
    if tp is None or m <= 1:
        return None
    h, kv = mc.num_heads, mc.num_kv_heads
    attn = not mc.mla.enabled and h % m == 0 and kv % m == 0
    gqa = (not mc.mla.enabled and h % m == 0 and kv % m != 0
           and m % kv == 0)
    mla = mc.mla.enabled and h % m == 0
    mlp = mc.d_ff > 0 and mc.d_ff % m == 0
    kinds = set(mc.layer_kinds)
    mamba = "mamba" in kinds and mc.d_inner % m == 0
    rglru = "rglru" in kinds and mc.rglru.lru_width % m == 0
    e, shared = mc.moe.num_experts, mc.moe.num_shared_experts
    experts = (e > 0 and e % m == 0
               and (mc.moe.d_ff_expert * shared) % m == 0)
    local = dataclasses.replace(
        mc, num_heads=h // m if attn or gqa or mla else h,
        num_kv_heads=kv // m if attn else 1 if gqa else kv,
        d_ff=mc.d_ff // m if mlp else mc.d_ff,
        ssm=dataclasses.replace(mc.ssm, d_inner=mc.d_inner // m)
        if mamba else mc.ssm,
        rglru=dataclasses.replace(mc.rglru,
                                  lru_width=mc.rglru.lru_width // m)
        if rglru else mc.rglru,
        moe=dataclasses.replace(mc.moe, num_experts=e // m)
        if experts else mc.moe)
    return ModelSplit(axis_group(rules.mesh, tp), local, attn, mlp,
                      mc.vocab_size % m == 0, rules.sp, tp, gqa=gqa,
                      mamba=mamba, experts=experts, kv_heads=kv,
                      rglru=rglru, mla=mla,
                      mtp=mc.mtp_depth > 0 and mc.d_model % m == 0)


def _spec_paths(fn, specs, prefix: str = ""):
    """``fn(path, spec)`` over a spec tree (PSpec leaves, dicts and
    lists), the paths as ``checkpoint.tree_paths`` names the values."""
    if isinstance(specs, PSpec):
        return fn(prefix, specs)
    if isinstance(specs, dict):
        return {k: _spec_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_spec_paths(fn, v, f"{prefix}/{i}" if prefix
                                       else str(i))
                           for i, v in enumerate(specs))
    return specs


def split_specs(split: Optional[ModelSplit], pspecs) -> Tuple[Any, Any]:
    """(the specs a step gathers the params by, the tree of split flags):
    a leaf the plan splits keeps its ``model`` block (its spec without the
    axis: gathered over the data axes only); every other leaf is gathered
    whole. Without a plan the specs themselves, no leaf split."""
    def flag(path, spec):
        return (split is not None and split.splits(path)
                and split.tp_axis in spec)

    def gather_by(path, spec):
        if not flag(path, spec):
            return spec
        return PSpec(*(None if e == split.tp_axis else e for e in spec))
    return _spec_paths(gather_by, pspecs), _spec_paths(flag, pspecs)


def current_split() -> Optional[ModelSplit]:
    return _STATE.split


@contextlib.contextmanager
def use_split(split: Optional[ModelSplit]):
    """The plan the layers read (``models/transformer``, ``layers.embed``,
    ``train_step.cross_entropy``) for a sharded step's forward and
    backward (whose recomputed forward, under remat, reads it too)."""
    prev = _STATE.split
    _STATE.split = split
    try:
        yield split
    finally:
        _STATE.split = prev


# ---------------------------------------------------------------------------
# Quantization-group sharding
# ---------------------------------------------------------------------------

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

    def local(self, x: Tensor, kind: str) -> Tensor:
        """This rank's block of a whole tensor (a view)."""
        return local_block(x, self.spec(kind), self.mesh)

    def gather(self, x: Tensor, kind: str) -> Tensor:
        """The whole tensor, on every rank, from the ranks' blocks."""
        return gather_block(x, self.spec(kind), self.mesh)

    def own(self, x: Tensor, kind: str, lanes: int,
            rows: Optional[int] = None) -> Tensor:
        """This rank's block of ``x``, which holds either the whole tensor
        (``lanes`` lanes, ``rows`` rows) or this rank's block already (a
        factor made lane-locally, a stage's unjoined output): a sharded dim
        is cut where it still has its whole size."""
        for d, ag in _spec_dims(self.spec(kind), self.mesh):
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
