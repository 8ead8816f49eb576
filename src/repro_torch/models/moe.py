"""Mixture-of-experts FFN with capacity-based sort dispatch.

The twin of the JAX package's ``models/moe.py``:

  - the router runs in float32 (its input is tapped as ``<name>.router``:
    calibration reads the MoE block inputs there; the router itself stays
    float); softmax, top-k, gates renormalized over the k;
  - dispatch sorts the flat (token, k) assignments by expert id (a stable
    sort), places each at its position inside its expert's segment
    (``searchsorted``) and scatters the kept ones into a dense (E, C, d)
    buffer; assignments past an expert's capacity C are dropped (they
    contribute nothing; the residual stream passes them through);
  - the experts are stacked (E, in, out) weights, float or int4-packed
    (a ``QuantizedTensor`` with a leading expert axis), run as bf16
    batched products with fp32 accumulation, as the reference does
    outside any Pallas kernel;
  - the combine sums each token's k gated contributions in ascending
    expert id, the order in which the reference's scatter-add meets them,
    by gathering them back through the inverse of the sort: no atomics,
    so a run repeats bitwise on the card and a captured step replays
    bitwise;
  - deepseek-style shared experts are a plain always-on MLP added to the
    routed output.

The structure of a dispatch (sort, positions, keeps, slots) is a function
of the expert ids alone: :func:`reuse_plan` rebinds a plan to a new head
with the same ids, which the overlap schedule's MoE flip repair relies on
(core/pipeline.py). The JAX package's ``flipped_assignments`` has no twin:
only its tests call it (the flip repair compares expert ids).

Every shape is static given the token count (``_capacity``), and nothing
reads a device value on the host, so a decode step holding it can be
captured into a CUDA graph.
"""
from __future__ import annotations

import math

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.quant import QuantizedTensor
from repro_torch.distributed.sharding import (copy_all_to_model,
                                              current_rules, psum,
                                              psum_local_grad)
from repro_torch.models.layers import _act, init_mlp, mlp
from repro_torch.models.linear import dense, init_dense

Tensor = torch.Tensor


class MoEOutput(NamedTuple):
    y: Tensor               # (B, S, D)
    aux_loss: Tensor        # scalar load-balance loss
    expert_load: Tensor     # (E,) routed tokens per expert, 1.0 = balanced


def init_moe(cfg: ModelConfig, gen: torch.Generator, device) -> Dict:
    """Random router, stacked (E, in, out) experts and shared experts with
    the JAX package's shapes and scales, drawn from ``gen``."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts

    def stack(shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    p = {"router": init_dense(gen, d, e, scale=0.02, device=device),
         "w_gate": stack((e, d, f), d ** -0.5),
         "w_up": stack((e, d, f), d ** -0.5),
         "w_down": stack((e, f, d), f ** -0.5)}
    if m.num_shared_experts > 0:
        p["shared"] = init_mlp(cfg, gen, d, f * m.num_shared_experts, False,
                               device)
    return p


def _expert_weights(w) -> Tensor:
    """The (E, in, out) bf16 view of stacked expert weights: a float
    tensor cast, or a ``QuantizedTensor`` of (E, out, in/2) codes with
    (E, out, groups) scales and zeros dequantized as ``(codes - z) · s`` in
    fp32 (broadcast over each group; bitwise the reference's repeat) and
    rounded once to bf16."""
    if not isinstance(w, QuantizedTensor):
        return w.to(torch.bfloat16)
    packed = w.packed
    e, o, kh = packed.shape
    codes = torch.stack([packed & 0x0F, packed >> 4], dim=-1)
    g = w.scales.shape[-1]
    wq = codes.reshape(e, o, g, -1).float()
    wq.sub_(w.zeros.float()[..., None]).mul_(w.scales.float()[..., None])
    return wq.reshape(e, o, kh * 2).to(torch.bfloat16).transpose(1, 2)


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Per-expert buffer rows for ``n_tokens`` tokens, rounded up to 8 as
    the reference rounds it (so the same assignments drop)."""
    m = cfg.moe
    c = int(m.capacity_factor * m.top_k * n_tokens / m.num_experts)
    return max(8, -(-c // 8) * 8)


class RouteHead(NamedTuple):
    """The router's output: top-k expert ids and their renormalized gates.
    Everything structural about dispatch is a function of ``experts``."""
    experts: Tensor     # (T, K) top-k expert ids
    gates: Tensor       # (T, K) renormalized gates
    aux: Tensor         # scalar load-balance loss


class RoutePlan(NamedTuple):
    """The head plus the sort-based placement."""
    experts: Tensor     # (T, K)
    gates: Tensor       # (T, K)
    aux: Tensor         # scalar
    order: Tensor       # (T*K,) stable argsort of the flat expert ids
    se: Tensor          # (T*K,) sorted expert ids
    st: Tensor          # (T*K,) source token per sorted assignment
    sg: Tensor          # (T*K,) gate per sorted assignment
    keep: Tensor        # (T*K,) kept (under capacity)
    slot: Tensor        # (T*K,) buffer row (E*C = the drop row)
    counts: Tensor      # (E,) int32 routed tokens per expert (pre-capacity)
    cap: int            # static per-expert capacity


class Dispatch(NamedTuple):
    """A dispatch plan and the dense per-expert input buffer."""
    buf: Tensor         # (E, C, d) expert inputs
    slot: Tensor
    st: Tensor
    sg: Tensor
    keep: Tensor
    aux: Tensor
    counts: Tensor


def route_head(cfg: ModelConfig, p: Dict, xt: Tensor,
               name: str = "moe") -> RouteHead:
    """Router forward and top-k on flat tokens xt (T, d)."""
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    logits = dense(p["router"], xt.float(), f"{name}.router")   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, k, dim=-1)
    # a row with a NaN (a poisoned decode lane's) takes the experts that
    # jax.lax.top_k gives it: NaN first, ties in index order, so it claims
    # the same capacity slots as in the reference
    nan_row = torch.isnan(probs).any(dim=-1, keepdim=True)
    key = torch.where(torch.isnan(probs), torch.full_like(probs, math.inf),
                      probs)
    nan_order = torch.sort(key, dim=-1, descending=True, stable=True)[1]
    experts = torch.where(nan_row, nan_order[:, :k], experts)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # Switch-style load balance: E · Σ_e f_e · P_e
    me = probs.mean(dim=0)
    fe = F.one_hot(experts[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(fe * me) * m.aux_loss_weight
    return RouteHead(experts, gates, aux)


def plan_from_head(cfg: ModelConfig, head: RouteHead) -> RoutePlan:
    """The structural dispatch plan of a head: sort, segment positions,
    capacity keeps, buffer slots."""
    e = cfg.moe.num_experts
    t, k = head.experts.shape
    dev = head.experts.device
    cap = _capacity(cfg, t)
    flat_e = head.experts.reshape(-1)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = flat_t[order]
    sg = head.gates.reshape(-1)[order]
    ids = torch.arange(e, device=dev, dtype=se.dtype)
    seg_start = torch.searchsorted(se, ids)
    seg_end = torch.searchsorted(se, ids, right=True)
    pos = torch.arange(t * k, device=dev) - seg_start[se]
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, torch.full_like(pos, e * cap))
    return RoutePlan(head.experts, head.gates, head.aux, order, se, st, sg,
                     keep, slot, (seg_end - seg_start).to(torch.int32), cap)


def route(cfg: ModelConfig, p: Dict, xt: Tensor,
          name: str = "moe") -> RoutePlan:
    """The full dispatch plan for flat tokens xt (T, d)."""
    return plan_from_head(cfg, route_head(cfg, p, xt, name))


def reuse_plan(plan: RoutePlan, head: RouteHead) -> RoutePlan:
    """Rebind a plan's structure to a fresh routing head whose expert ids
    equal ``plan.experts`` (the caller checks): sort order, positions,
    keeps, slots and counts carry over bitwise, the gates, the aux loss
    and the sorted gates come from the new head."""
    return plan._replace(experts=head.experts, gates=head.gates,
                         aux=head.aux,
                         sg=head.gates.reshape(-1)[plan.order])


def apply_route(plan: RoutePlan, xt: Tensor) -> Tensor:
    """Scatter flat tokens xt (T, d) into the (E, C, d) expert buffer. Every
    dropped assignment writes the drop row, which is cut off."""
    e, cap = plan.counts.shape[0], plan.cap
    buf = xt.new_zeros((e * cap + 1, xt.shape[-1]))
    buf[plan.slot] = xt[plan.st]
    return buf[:-1].reshape(e, cap, -1)


def dispatch(cfg: ModelConfig, p: Dict, xt: Tensor,
             name: str = "moe") -> Dispatch:
    """Route flat tokens xt (T, d) to the (E, C, d) expert buffer."""
    plan = route(cfg, p, xt, name)
    return Dispatch(apply_route(plan, xt), plan.slot, plan.st, plan.sg,
                    plan.keep, plan.aux, plan.counts)


def _expert_product(a: Tensor, w) -> Tensor:
    """(E, C, in) bf16 @ the (E, in, out) experts → (E, C, out) bf16, fp32
    accumulation."""
    return torch.bmm(a, _expert_weights(w))


def moe_ffn(cfg: ModelConfig, p: Dict, x: Tensor,
            name: str = "moe", split=None, reduce=None) -> MoEOutput:
    """x (B, S, D) → the routed expert mixture, same shape and dtype.

    Under a sharded step's experts split (``split``, a
    ``sharding.ModelSplit`` whose ``experts`` holds; ``p``'s expert
    stacks, and a shared expert's gate / up columns and down rows, the
    rank's ``model`` blocks) the routing runs whole on every rank, from x
    as it enters: the router, top-k, capacity, the stable-sort dispatch,
    the load-balance loss and the load. The rank then runs the products
    of its E/m experts on their rows of the (E, C, d) buffer and combines
    only their gated rows; ``reduce`` sums the fp32 partial over the axis
    (or reduce-scatters it over the sequence) before the cast. The
    buffer's input and the sorted gates enter the expert path through
    ``copy_to_model`` (the router's own input does not): x's gradient is
    the routing path's, whole on every rank, plus the summed expert
    path's, and the load-balance loss is counted once.

    Under sharding rules with ``ep_local_dispatch`` (the reference's
    ``shard_map`` over the data parallel axes) ``x`` is this rank's block
    of the batch, so dispatch is already local to the data shard and its
    capacity comes from the local token count; the load-balance loss and
    the expert load are then the mean over the data parallel group, the
    loss's gradient reaching this rank's parameters once
    (``sharding.psum_local_grad``)."""
    out = _moe_ffn_body(cfg, p, x, name, split, reduce)
    rules = current_rules()
    if (rules is not None and rules.dp_size() > 1
            and rules.ep_local_dispatch):
        group, n = rules.dp_group().group, rules.dp_size()
        aux = psum_local_grad(out.aux_loss, group)
        load = psum(out.expert_load, group)
        return MoEOutput(out.y, aux / torch.full_like(aux, n),
                         load / torch.full_like(load, n))
    return out


def _moe_ffn_body(cfg: ModelConfig, p: Dict, x: Tensor,
                  name: str = "moe", split=None, reduce=None) -> MoEOutput:
    m = cfg.moe
    b, s, d = x.shape
    t, e, k = b * s, m.num_experts, m.top_k
    xt = x.reshape(t, d)
    plan = route(cfg, p, xt, name)
    cap = plan.cap
    if split is None:
        el, keep, slot, xe, sg = e, plan.keep, plan.slot, xt, plan.sg
        buf = apply_route(plan, xt)
    else:
        # the rank's experts [lo, lo + el): its rows of the buffer
        el = split.cfg.moe.num_experts
        lo = split.index * el
        keep = plan.keep & (plan.se >= lo) & (plan.se < lo + el)
        slot = torch.where(keep, plan.slot - lo * cap,
                           torch.full_like(plan.slot, el * cap))
        xe, sg = copy_all_to_model(split.ag.group, xt, plan.sg)
        buf = xe.new_zeros((el * cap + 1, d))
        buf[slot] = xe[plan.st]
        buf = buf[:-1].reshape(el, cap, d)

    buf = buf.to(torch.bfloat16)
    g = _expert_product(buf, p["w_gate"])
    u = _expert_product(buf, p["w_up"])
    hmid = _act(cfg.act, g.float()).to(torch.bfloat16) * u
    yexp = _expert_product(hmid, p["w_down"])                   # (E, C, d)

    # combine: each sorted assignment's gated contribution (0 if dropped),
    # gathered back to (token, k) through the inverse of the sort, then
    # summed per token in ascending expert id
    yflat = yexp.reshape(el * cap, d)
    rows = yflat[slot.clamp(max=el * cap - 1)]
    contrib = torch.where(keep[:, None], rows,
                          torch.zeros_like(rows)).float() * sg[:, None]
    inv = torch.empty_like(plan.order)
    inv[plan.order] = torch.arange(t * k, device=x.device)
    by_expert = torch.argsort(plan.experts, dim=1, stable=True)  # (T, K)
    flat = (torch.arange(t, device=x.device)[:, None] * k
            + by_expert).reshape(-1)
    parts = contrib[inv[flat]].reshape(t, k, d)
    y = parts[:, 0]
    for j in range(1, k):
        y = y + parts[:, j]

    load = plan.counts.float() * e / (t * k)
    if split is not None:
        y = y.reshape(b, s, d)
        if reduce is not None:
            y = reduce(y)
        if m.num_shared_experts > 0:
            y = y + mlp(cfg, p["shared"], xe.reshape(b, s, d),
                        name=f"{name}.shared", reduce=reduce).float()
        return MoEOutput(y.to(x.dtype), plan.aux, load)
    if m.num_shared_experts > 0:
        y = y + mlp(cfg, p["shared"], xt[None],
                    name=f"{name}.shared")[0].float()
    return MoEOutput(y.reshape(b, s, d).to(x.dtype), plan.aux, load)
