"""Loss and train step for decoder-only and encoder-decoder models.

The twin of the JAX package's ``training/train_step.py``:

  - next-token cross-entropy with an optional loss mask; a batch with
    frontend ``embeds`` (pixtral) takes the loss over the token region
    only; an encoder-decoder (whisper) runs ``encdec_forward`` on the
    batch's ``frames``;
  - the routed-MoE load-balance loss, and deepseek's MTP cross-entropy at
    ``model.mtp_loss_weight`` (not with frontend embeds);
  - gradient accumulation over ``train.grad_accum`` microbatches (f32
    sums divided by the count, the last microbatch's metrics), global-norm
    clipping at ``train.grad_clip``, the schedule's learning rate, AdamW
    (int8 moments with ``parallel.int8_optimizer_state``);
  - ``parallel.remat`` other than ``"none"``: each super-block recomputed
    in the backward (``transformer.forward_train``).

A :class:`TrainState` holds the parameters in the JAX package's layout:
decoder-only layers stacked into ``blocks[seg]["sub<i>"]`` along a leading
(count,) axis, an encoder-decoder's ``encoder.layers`` / ``decoder.layers``
stacked (``convert.stack_layers``), every leaf in ``model.param_dtype``.
So its leaves, its int8 moment blocks and its checkpoint paths
(``.params/blocks/0/sub0/mixer/q/w``, ``.opt/.m/…/.q``, ``.opt/.step``,
``.step``) are the JAX TrainState's. The forward reads each layer as a
view of the stacked leaves (``convert.unstack_layers``), and autograd
brings the gradients back to the stacked leaves. Gradients come from
autograd in the parameters' dtype; every layer casts to the compute dtype
where the reference casts.

The step donates its input state, as the JAX trainer's ``jit`` does: the
parameters and moments are updated in place and the returned state holds
the same tensors.

:func:`make_sharded_train_step` is the step on a mesh of ranks
(``torch.distributed``, one process a rank): explicit data parallelism
over the data parallel axes with the train state sharded by the JAX
package's placement rules (``distributed/sharding.py``), and the ``model``
axis computing its share as GSPMD does: the Megatron products split over
it (``sharding.model_split``), the loss vocab-parallel and, with
``parallel.sp``, the residual's sequence over it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import Config
from repro_torch.convert import stack_layers, unstack_layers
from repro_torch.distributed import sharding
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as opt
from repro_torch.training.schedule import learning_rate

Tensor = torch.Tensor


class TrainState(NamedTuple):
    params: Any             # the JAX layout (module docstring)
    opt: opt.AdamWState
    step: Tensor            # int32 scalar


def init_train_state(cfg: Config, device) -> TrainState:
    """Fresh weights from a ``torch.Generator`` seeded ``train.seed`` on
    ``device`` (torch cannot draw JAX's bits: tests convert the JAX
    package's init instead), stacked into the JAX layout and cast to
    ``model.param_dtype``; zero moments and step 0."""
    mc = cfg.model
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.train.seed)
    params = (T.init_encdec_params(mc, gen, device) if mc.is_encoder_decoder
              else T.init_params(mc, gen, device))
    return state_from_params(cfg, stack_layers(mc, params))


def state_from_params(cfg: Config, params: Any) -> TrainState:
    """A step-0 state around parameters in the JAX layout (cast to
    ``model.param_dtype``), with zero moments."""
    pdtype = getattr(torch, cfg.model.param_dtype)
    params = opt.tree_map(lambda a: a.detach().to(pdtype).clone(), params)
    dev = opt.tree_leaves(params)[0].device
    return TrainState(params, opt.adamw_init(
        params, int8=cfg.parallel.int8_optimizer_state),
        torch.zeros((), dtype=torch.int32, device=dev))


def _logz_gold(logits: Tensor, targets: Tensor) -> Tuple[Tensor, Tensor]:
    """(log Σ exp, the target's logit) per position. Vocab-parallel
    logits (a model split's vocab block of V/m columns): the max over the
    axis (MAX all-reduce, no gradient), the sum of exp over it, and the
    target's logit from the rank that owns it (sums whose backward stays
    on the rank: every rank of the axis goes on to the same loss)."""
    split = sharding.current_split()
    if split is None or not split.vocab:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, targets[..., None].long(),
                                    dim=-1)[..., 0]
        return logz, gold
    group, n = split.ag.group, logits.shape[-1]
    mx = sharding.pmax(logits.detach().amax(dim=-1), group)
    sumexp = sharding.reduce_from_model(
        torch.exp(logits - mx[..., None]).sum(dim=-1), group)
    local = targets.long() - split.index * n
    own = (local >= 0) & (local < n)
    gold = torch.take_along_dim(logits, torch.where(own, local, 0)[..., None],
                                dim=-1)[..., 0]
    gold = sharding.reduce_from_model(torch.where(own, gold, 0.0), group)
    return mx + torch.log(sumexp), gold


def cross_entropy(logits: Tensor, targets: Tensor,
                  mask: Optional[Tensor]) -> Tensor:
    """Mean CE over the masked positions; logits (B, S, V) f32 (under a
    model split that covers the vocab, the rank's (B, S, V/m) block),
    targets (B, S). Under sharding rules with more than one data parallel
    rank the batch is this rank's block and the mean is the global
    batch's: the count is summed over the group, and so is the numerator,
    whose gradient stays local (``sharding.psum_local_grad``)."""
    logz, gold = _logz_gold(logits, targets)
    ce = logz - gold
    rules = sharding.current_rules()
    group = (rules.dp_group().group
             if rules is not None and rules.dp_size() > 1 else None)
    if mask is None:
        if group is None:
            return ce.mean()
        total = sharding.psum_local_grad(ce.sum(), group)
        return total / torch.full_like(total, ce.numel() * rules.dp_size())
    m = mask.float()
    num, den = torch.sum(ce * m), torch.sum(m)
    if group is not None:
        num = sharding.psum_local_grad(num, group)
        den = sharding.psum(den, group)
    return num / torch.clamp_min(den, 1.0)


def loss_fn(cfg: Config, params: Any, batch: Dict[str, Tensor]
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """(loss, metrics {"ce", "aux", ("mtp_ce",) "loss"}) of a batch on the
    parameters' device; ``params`` in the JAX layout."""
    mc = cfg.model
    remat = cfg.parallel.remat != "none"
    tp = unstack_layers(params)
    tokens = batch["tokens"]
    mask = batch.get("loss_mask")
    embeds = batch.get("embeds")
    h = None
    if mc.is_encoder_decoder:
        logits, aux = T.encdec_forward(mc, tp, batch["frames"], tokens)
    else:
        logits, aux, h = T.forward_train(mc, tp, tokens, embeds, remat=remat,
                                         return_hidden=True)
        if embeds is not None:
            # the frontend positions come first: the loss covers the tokens
            logits = logits[:, embeds.shape[1]:]
    ce = cross_entropy(logits[:, :-1], tokens[:, 1:],
                       None if mask is None else mask[:, 1:])
    loss = ce + aux
    metrics = {"ce": ce, "aux": aux}
    if mc.mtp_depth > 0 and not mc.is_encoder_decoder and embeds is None:
        mtp_lg = T.mtp_logits(mc, tp, h, tokens)          # (B, S-1, V)
        mtp_ce = cross_entropy(mtp_lg[:, :-1], tokens[:, 2:], None)
        loss = loss + mc.mtp_loss_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics


def loss_and_grads(cfg: Config, params: Any, batch: Dict[str, Tensor]
                   ) -> Tuple[Any, Dict[str, Tensor]]:
    """The gradients of :func:`loss_fn` (a tree like ``params``, in the
    parameters' dtypes) and its metrics, detached."""
    leaves = opt.tree_leaves(params)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = loss_fn(cfg, params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    it = iter(grads)
    return (opt.tree_map(lambda _: next(it), params),
            {k: v.detach() for k, v in metrics.items()})


def accumulated_grads(cfg: Config, params: Any, batch: Dict[str, Tensor],
                      block: Callable = lambda micro: micro
                      ) -> Tuple[Any, Dict[str, Tensor]]:
    """The batch's gradients over ``train.grad_accum`` microbatches (rows
    split in order): f32 sums divided by the count, and the last
    microbatch's metrics; one batch's gradients when it is 1. ``block``
    maps a microbatch to the rows this rank runs (the sharded step's data
    parallel block)."""
    accum = max(1, cfg.train.grad_accum)
    if accum == 1:
        return loss_and_grads(cfg, params, block(batch))
    n = next(iter(batch.values())).shape[0] // accum
    grads = opt.tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    for i in range(accum):
        micro = block({k: v[i * n:(i + 1) * n] for k, v in batch.items()})
        g, metrics = loss_and_grads(cfg, params, micro)
        grads = opt.tree_map(torch.add, grads, g)
        del g
    grads = opt.tree_map(lambda g: g / torch.full_like(g, accum), grads)
    return grads, metrics


def make_train_step(cfg: Config) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: the batch's
    gradients (:func:`accumulated_grads`), clipped, then an AdamW step at
    the schedule's rate; ``metrics`` are the loss terms, ``grad_norm`` and
    ``lr`` (0-dim tensors on the device). The input state is donated
    (module docstring)."""
    tc = cfg.train
    int8 = cfg.parallel.int8_optimizer_state

    def train_step(state: TrainState, batch: Dict[str, Tensor]
                   ) -> Tuple[TrainState, Dict[str, Tensor]]:
        batch = {k: v.to(state.step.device) for k, v in batch.items()}
        grads, metrics = accumulated_grads(cfg, state.params, batch)
        grads, gnorm = opt.clip_by_global_norm(grads, tc.grad_clip)
        lr = learning_rate(tc, state.step)
        params, ostate = opt.adamw_update(grads, state.opt, state.params,
                                          lr=lr, tc=tc, int8=int8)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return TrainState(params, ostate, state.step + 1), metrics

    return train_step


def _adamw_int8_blocks(grads: Any, params: Any, state: TrainState,
                       specs: TrainState, mesh, lr: Tensor, tc
                       ) -> opt.AdamWState:
    """AdamW with int8 moments on this rank's moment blocks.

    A moment's (n_blocks, 128) blocks cover the flattened, zero-padded
    leaf; its scales shard their block dim over ``data`` (its codes are
    replicated, ``sharding.train_state_pspecs``). So the rank updates the
    flat range its scales cover, from the whole parameters and gradient
    (the padding stays zero, so each block requantizes as on one device;
    the caller gathers a split leaf's over ``model``), then joins the
    ranges over ``data``: the parameters, whose own blocks follow the
    param spec, and the replicated codes."""
    rng_p, rng_g, rng_m, rng_v, joins = [], [], [], [], []

    def take(p_loc, p_all, g, m, v, pspec, mspec):
        nb, blk = m.q.shape
        ag = (sharding.axis_group(mesh, mspec.scale[0])
              if mspec.scale[0] is not None else None)
        rows = nb // ag.size if ag is not None else nb
        r0 = ag.index * rows if ag is not None else 0

        def flat_range(t):
            f = torch.nn.functional.pad(t.reshape(-1),
                                        (0, nb * blk - t.numel()))
            return f.narrow(0, r0 * blk, rows * blk)
        rng_p.append(flat_range(p_all).clone())
        rng_g.append(flat_range(g))
        rng_m.append(opt.Quantized8(m.q.narrow(0, r0, rows), m.scale))
        rng_v.append(opt.Quantized8(v.q.narrow(0, r0, rows), v.scale))
        joins.append((p_loc, p_all, pspec, ag, m.q, v.q, r0, rows))

    opt.tree_map(take, state.params, params, grads, state.opt.m,
                 state.opt.v, specs.params, specs.opt.m)
    _, ost = opt.adamw_update(rng_g, opt.AdamWState(
        state.opt.step, rng_m, rng_v), rng_p, lr=lr, tc=tc, int8=True)
    for p_new, (p_loc, p_all, pspec, ag, mq, vq, r0, rows) in zip(rng_p,
                                                                 joins):
        if ag is not None:
            p_new = sharding.all_gather_cat(p_new, 0, ag)
            for q in (mq, vq):
                q.copy_(sharding.all_gather_cat(q.narrow(0, r0, rows), 0,
                                                ag))
        whole = p_new[:p_all.numel()].reshape(p_all.shape)
        p_loc.copy_(sharding.local_block(whole, pspec, mesh))
    return opt.AdamWState(ost.step, state.opt.m, state.opt.v)


def _split_global_norm(grads: Any, flags: Any,
                       plan: Optional[sharding.ModelSplit]) -> Tensor:
    """The global norm of gradients whose split leaves (``flags``) hold
    the rank's ``model`` block: their squares summed over the axis, every
    other leaf's counted once (each in tree order, in f32)."""
    sums: Dict[bool, Tensor] = {}
    for g, split in zip(opt.tree_leaves(grads), opt.tree_leaves(flags)):
        s = torch.sum(torch.square(g.float()))
        sums[split] = s if split not in sums else sums[split] + s
    total = sums.get(False)
    if True in sums:
        part = sharding.psum(sums[True], plan.ag.group)
        total = part if total is None else total + part
    return torch.sqrt(total)


def make_sharded_train_step(cfg: Config, rules: sharding.Rules,
                            specs: TrainState) -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` on a mesh of ranks.

    ``state`` holds this rank's block of every leaf under ``specs``
    (``sharding.train_state_pspecs``); ``batch`` is the global batch, the
    same on every rank. A step gathers the parameters, runs the loss and
    backward on the rank's data parallel block of each microbatch
    (``sharding.batch_pspecs``; a batch that does not split stays whole on
    every rank, as JAX's guard, and so does a routed MoE's under
    ``ep_local_dispatch=false``, whose dispatch is global), sums the
    gradients over the data parallel group into the global batch's,
    clips them by their global norm and runs AdamW on the rank's blocks.

    On a ``model`` axis of m > 1 ranks (``sharding.model_split``) the
    leaves the plan splits are gathered over the data axes only and the
    rank computes with its ``model`` block of them (1/m of the heads or
    q-heads, MLA's heads, ``d_ff``, vocab, Mamba's ``d_inner``, RG-LRU's
    ``lru_width``, the routed experts and the MTP projection's columns;
    the layers under ``sharding.use_split``); every other leaf is
    gathered whole and computed whole (a GQA layer's k / v, of which each
    rank reads its kv-head's columns; MLA's latent projections). A split
    leaf's gradient is the rank's block: the global norm sums its squares
    over the axis, and int8 moments, whose blocks cover the whole leaf,
    update from its gradient gathered over ``model``. ``parallel.sp``
    puts the residual's sequence over the axis.

    The metrics are the global batch's (the last microbatch's under
    ``train.grad_accum``), the same on every rank. The input state is
    donated."""
    tc = cfg.train
    int8 = cfg.parallel.int8_optimizer_state
    mesh = rules.mesh
    dp = rules.dp_group() if rules.dp_size() > 1 else None
    global_dispatch = (cfg.model.moe.num_experts > 0
                       and not rules.ep_local_dispatch)
    accum = max(1, tc.grad_accum)
    plan = sharding.model_split(cfg.model, rules)
    gather_by, flags = sharding.split_specs(plan, specs.params)

    def block(micro):
        return sharding.local(micro, sharding.batch_pspecs(micro, rules),
                              mesh)

    def whole_over_model(tree):
        """The split leaves gathered over ``model`` (the others as
        they are)."""
        return opt.tree_map(
            lambda t, split, spec: sharding.gather_block(t, sharding.PSpec(
                *(e if e == plan.tp_axis else None for e in spec)), mesh)
            if split else t, tree, flags, specs.params)

    def train_step(state: TrainState, batch: Dict[str, Tensor]
                   ) -> Tuple[TrainState, Dict[str, Tensor]]:
        batch = {k: v.to(state.step.device) for k, v in batch.items()}
        params = sharding.gather(state.params, gather_by, mesh)
        rows = next(iter(batch.values())).shape[0] // accum
        split = dp is not None and rows % dp.size == 0 \
            and not global_dispatch
        with sharding.use_rules(rules if split else None), \
                sharding.use_split(plan):
            grads, metrics = accumulated_grads(
                cfg, params, batch, block if split else (lambda m: m))
        if split:
            grads = sharding.psum_tree(grads, dp.group)
        grads, gnorm = opt.clip_by_global_norm(
            grads, tc.grad_clip, _split_global_norm(grads, flags, plan))
        lr = learning_rate(tc, state.step)
        if int8:
            if plan is not None:
                grads, params = whole_over_model(grads), \
                    whole_over_model(params)
            ostate = _adamw_int8_blocks(grads, params, state, specs, mesh,
                                        lr, tc)
        else:
            _, ostate = opt.adamw_update(
                sharding.local(grads, gather_by, mesh), state.opt,
                state.params, lr=lr, tc=tc)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return TrainState(state.params, ostate, state.step + 1), metrics

    return train_step
