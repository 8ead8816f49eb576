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
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import Config
from repro_torch.convert import stack_layers, unstack_layers
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


def cross_entropy(logits: Tensor, targets: Tensor,
                  mask: Optional[Tensor]) -> Tensor:
    """Mean CE over the masked positions; logits (B, S, V) f32, targets
    (B, S)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets[..., None].long(),
                                dim=-1)[..., 0]
    ce = logz - gold
    if mask is None:
        return ce.mean()
    m = mask.float()
    return torch.sum(ce * m) / torch.clamp_min(torch.sum(m), 1.0)


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


def accumulated_grads(cfg: Config, params: Any, batch: Dict[str, Tensor]
                      ) -> Tuple[Any, Dict[str, Tensor]]:
    """The batch's gradients over ``train.grad_accum`` microbatches (rows
    split in order): f32 sums divided by the count, and the last
    microbatch's metrics; one batch's gradients when it is 1."""
    accum = max(1, cfg.train.grad_accum)
    if accum == 1:
        return loss_and_grads(cfg, params, batch)
    n = next(iter(batch.values())).shape[0] // accum
    grads = opt.tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    for i in range(accum):
        micro = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
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
