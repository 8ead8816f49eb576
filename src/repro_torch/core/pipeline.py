"""The RPIQ model-quantization pipeline (the paper's end-to-end procedure).

Sequential layer-wise calibration, as GPTQ practice and the JAX package
do it:

  1. embed every calibration batch → residual streams ``hs``;
  2. for each layer:
     a. **capture** — run the layer over all batches under a :class:`Tap`
        that streams each named linear's inputs into its Hessian
        (eq. 9, ``H += X_bᵀX_b`` through the ``hessian_accum`` kernel) and
        keeps only the **last** batch's inputs (the single instance,
        eq. 11);
     b. **plan** — group the captured linears by shape class; a routed-MoE
        layer's experts join as stacked members (below);
     c. **execute** — stage 1 (GPTQ) and stage 2 (RPIQ) per group;
     d. **scatter** the on-grid weights and their stage-1 grid back into
        the layer, then **propagate** the quantized layer's outputs to the
        next layer, so later Hessians see the quantized network.

A routed-MoE layer's router stays float: its tap only collects the MoE
block inputs. From them, :func:`_moe_members` dispatches each batch as the
forward does and accumulates one stacked (E, ·, ·) Hessian per input kind
(the experts' gate/up inputs, and their fp32 mid activations for
``w_down``); each of ``w_gate``, ``w_up`` and ``w_down`` joins the plan as
one stacked member of E lanes (gate and up share a group of 2E), and an
expert that saw fewer routed tokens than one quant group is RTN-quantized
(a mask inside its group, core/plan.py). Capacity-dropped assignments
reach no Hessian; the report counts them per layer.

Every layer kind goes through the same capture: an MLA mixer's seven
linears (``q_down, q_up, kv_down, k_rope, k_up, v_up, o``) and an RG-LRU
mixer's five (``in, gate, rg, ig, out``) are named denses; the RG-LRU's
conv taps are no dense, so they get no Hessian and stay float, as in the
JAX package.

An encoder-decoder walks its encoder layers on the encoder stream, then,
behind a :class:`~repro_torch.core.stream.StreamSwitch` fence, its decoder
layers on the decoder stream (:func:`_walker_encdec`).

``quant.pipeline=overlap`` (core/stream.py) runs the next layer's capture
ahead, speculatively, on this layer's pre-quantization outputs
(``capture_layer(speculative=True)`` on the outputs a
``collect_h_out=True`` capture kept). A dense speculation is discarded:
the true capture after the scatter repeats it on the quantized stream.
A routed-MoE layer's speculation also routes each batch; at the layer's
own turn :func:`_moe_members` recomputes only the routing head on the
true stream, reuses a batch's speculative plan where no expert id
flipped, re-plans it where one did, and discards every speculative plan
of the layer when the flipped share exceeds ``quant.moe_flip_budget``
(the plan-level flip repair). The per-expert Hessians always accumulate
true-stream values, so overlap stays bitwise serial.

``quant.mesh`` (``quantize_model(mesh=)``) shards the plan's groups over
a ``torch.distributed`` world, one process a rank (core/plan.py,
``launch/mesh.py``): rank 0 broadcasts the params and the calibration
batches once, every rank walks the same layers and ends with the same
quantized tree.

:func:`pack_for_serving` then turns every quantized linear into an int4
:class:`~repro_torch.core.quant.QuantizedTensor` on its stage-1 grid,
through the ``quant_pack`` kernel on the card (a stacked expert weight as
one (E·out, in) matrix).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.config import Config
from repro_torch.core import faults
from repro_torch.core import hessian as hess
from repro_torch.core import plan as qplan
from repro_torch.core import stream as qstream
from repro_torch.core.plan import MemberResult, PlanMember, QuantReport
from repro_torch.core.quant import (QuantizedTensor, QuantParams,
                                    compute_qparams)
from repro_torch.core.stream import LayerStep, LayerWalker, StreamSwitch
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as T
from repro_torch.models.layers import _act, norm
from repro_torch.models.linear import Tap

Tensor = torch.Tensor

# a layer's subtrees whose linears are calibrated (a layer's top-level keys,
# as the JAX package picks them); norms / embeddings / lm_head stay fp
_QUANT_SUBTREES = ("mixer", "mlp", "xattn")
_MOE_WNAMES = ("w_gate", "w_up", "w_down")


def _resolve(tree: Dict, dotted: str):
    node = tree
    for part in dotted.split("."):
        node = node[part]
    return node


def _linear_names_in(tree: Dict, prefix: str = "") -> List[str]:
    """Dotted paths of {w: 2-D tensor} dense params inside a subtree."""
    out = []
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            w = v.get("w")
            if isinstance(w, Tensor) and w.dim() == 2:
                out.append(path)
            else:
                out.extend(_linear_names_in(v, path))
    return out


def _copy_tree(tree):
    """New dict/list structure over the same tensors."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _is_moe_layer(layer_params: Dict) -> bool:
    mlp = layer_params.get("mlp")
    return isinstance(mlp, dict) and "w_gate" in mlp


def _layer_repair_sound(layer_params: Dict) -> bool:
    """Whether the overlap schedule may capture this layer ahead. Every
    layer is: a dense capture is repeated on the true stream, a routed-MoE
    layer repairs at the plan level (:func:`_moe_members`). A predicate,
    as in the JAX package, so that tests can force the serial
    re-capture."""
    del layer_params
    return True


@dataclasses.dataclass
class CaptureResult:
    """One layer's calibration state: Hessians and last-batch inputs of
    its dense linears, and for a routed-MoE layer each batch's flat MoE
    block inputs (T, d) from the router's tap. ``h_out``: the layer's
    per-batch outputs, the pre-quantization stream the overlap schedule
    speculates on (kept only on request). ``spec_routes``: a speculative
    capture's per-batch routing plans of a routed-MoE layer."""
    hessians: Dict[str, hess.HessianState]
    last_x: Dict[str, Tensor]
    moe_xs: List[Tensor]
    is_moe: bool
    h_out: Optional[List[Tensor]] = None
    spec_routes: Optional[List[moe_mod.RoutePlan]] = None


def capture_layer(cfg: Config, step: LayerStep, hs: List[Tensor],
                  speculative: bool = False, collect_h_out: bool = False
                  ) -> CaptureResult:
    """Stage (a): stream Hessians over all batches, keep the last inputs.
    The ``stream.capture_forward`` fault site fires first, for a
    speculative capture too (so a ``site@N`` schedule lands where it does
    in the JAX package). ``speculative``: the overlap schedule's capture
    ahead, which for a routed-MoE layer also routes each batch
    (``spec_routes``); ``collect_h_out`` keeps the layer's outputs."""
    faults.fire("stream.capture_forward")
    layer_params = step.resolve_params()
    is_moe = _is_moe_layer(layer_params)
    targets = set()
    for sub in _QUANT_SUBTREES:
        if sub in layer_params:
            targets.update(f"{sub}.{n}"
                           for n in _linear_names_in(layer_params[sub]))
    # the router stays float; its tap collects the MoE block inputs
    targets.discard("mlp.router")
    hessians: Dict[str, hess.HessianState] = {}
    last_x: Dict[str, Tensor] = {}
    moe_xs: List[Tensor] = []

    def on_record(name: str, x: Tensor) -> None:
        if name == "mlp.router":
            moe_xs.append(x.reshape(-1, x.shape[-1]))
            return
        if name not in targets:
            return
        x2 = x.reshape(-1, x.shape[-1])
        if name not in hessians:
            hessians[name] = hess.init_hessian(x2.shape[1], device=x.device)
        hessians[name] = hess.accumulate(hessians[name], x2)
        last_x[name] = x2            # overwritten per batch: the last stays

    h_out: Optional[List[Tensor]] = [] if collect_h_out else None
    with torch.no_grad(), Tap(on_record=on_record):
        for bi, h in enumerate(hs):
            out = step.apply_fn(layer_params, h, bi)
            if collect_h_out:
                h_out.append(out)
    if is_moe and len(moe_xs) != len(hs):
        raise RuntimeError(f"{step.name}: the router's tap saw "
                           f"{len(moe_xs)} of {len(hs)} batches")
    spec_routes = None
    if speculative and is_moe:
        dtype = T.compute_dtype(cfg.model)
        with torch.no_grad():
            spec_routes = [moe_mod.route(cfg.model, layer_params["mlp"],
                                         xt.to(dtype)) for xt in moe_xs]
    return CaptureResult(hessians, last_x, moe_xs, is_moe, h_out,
                         spec_routes)


@torch.no_grad()
def _moe_members(cfg: Config, p_moe: Dict, xs: List[Tensor], name: str,
                 report: Optional[QuantReport] = None,
                 layer_name: str = "layer", stats: Optional[Dict] = None,
                 spec_routes: Optional[List[moe_mod.RoutePlan]] = None
                 ) -> List[PlanMember]:
    """The routed experts' plan members (the paper's method per expert).

    ``xs``: each calibration batch's flat MoE block inputs (T, d). Every
    batch is routed and dispatched as the forward does; the (E, C, d)
    buffer's rows (capacity padding is zero rows, which add nothing to
    XᵀX) feed one stacked (E, d, d) Hessian for ``w_gate`` and ``w_up``,
    and the experts' fp32 mid activations ``act(x W_gate) · x W_up`` one
    (E, f, f) Hessian for ``w_down``. The routed counts and capacity drops
    come to the host in one sync. Each lane's Hessian count is its routed
    tokens over all batches, its stage-2 ``x_count`` the last batch's
    pre-capacity count, and a lane with fewer routed tokens than one
    quant group is starved, as in the JAX package.

    ``spec_routes`` (the overlap schedule): the plans a speculative capture
    made on the pre-quantization stream. The routing head is recomputed
    here on the true stream and the expert ids that flipped are counted in
    one host read; a batch with none reuses its speculative plan
    (``moe.reuse_plan``), a batch with some is planned anew, and past
    ``quant.moe_flip_budget`` every speculative plan of the layer is
    discarded. ``stats`` takes the flip repair's counters and
    ``moe_dropped_tokens``."""
    qc, mc = cfg.quant, cfg.model
    e = mc.moe.num_experts
    d, f = p_moe["w_gate"].shape[1:]
    dev = xs[0].device
    dtype = T.compute_dtype(mc)
    xs_c = [xt.to(dtype) for xt in xs]

    def bump(key: str, n: int = 1) -> None:
        if stats is not None:
            stats[key] = stats.get(key, 0) + int(n)

    plans = None
    if spec_routes is not None and len(spec_routes) == len(xs_c):
        heads = [moe_mod.route_head(mc, p_moe, xt) for xt in xs_c]
        flips = torch.stack([(h.experts != sp.experts).sum()
                             for h, sp in zip(heads, spec_routes)]
                            ).cpu().numpy()               # one host read
        n_assign = sum(h.experts.numel() for h in heads)
        n_flips = int(flips.sum())
        bump("moe_spec_layers")
        bump("moe_flipped_assignments", n_flips)
        bump("moe_assignments", n_assign)
        if n_assign and n_flips / n_assign > qc.moe_flip_budget:
            # too much of the routing moved: re-plan the layer serially
            bump("fallback_flip_budget")
            bump("serial_fallbacks")
        else:
            plans = []
            for h, sp, nf in zip(heads, spec_routes, flips):
                if nf == 0:
                    plans.append(moe_mod.reuse_plan(sp, h))
                    bump("moe_plan_reuses")
                else:
                    plans.append(moe_mod.plan_from_head(mc, h))
                    bump("moe_flip_repairs")
    if plans is None:
        plans = [moe_mod.route(mc, p_moe, xt) for xt in xs_c]
    w_gate, w_up = p_moe["w_gate"].float(), p_moe["w_up"].float()
    H_in = hess.init_hessian(d, batch=e, device=dev)
    H_mid = hess.init_hessian(f, batch=e, device=dev)
    x_last_in = x_last_mid = None
    for plan, xt in zip(plans, xs_c):
        buf = moe_mod.apply_route(plan, xt)                 # (E, C, d)
        bf = buf.float()
        mid = _act(mc.act, torch.bmm(bf, w_gate)) * torch.bmm(bf, w_up)
        H_in = hess.accumulate(H_in, buf)
        H_mid = hess.accumulate(H_mid, mid)
        x_last_in, x_last_mid = buf, mid
    del w_gate, w_up
    counts = torch.stack([p.counts for p in plans]).sum(dim=0)
    dropped = sum((~p.keep).sum() for p in plans)
    tallies = torch.cat([counts.to(torch.int64),
                         dropped.to(torch.int64)[None]]).cpu().numpy()
    real_counts, n_dropped = tallies[:e], int(tallies[e])
    bump("moe_dropped_tokens", n_dropped)
    if report is not None:
        report.moe_capacity_dropped[layer_name] = \
            report.moe_capacity_dropped.get(layer_name, 0) + n_dropped
    count_t = torch.as_tensor(real_counts, dtype=torch.int32, device=dev)
    last_counts = plans[-1].counts.to(torch.int32)
    starved = real_counts < qc.group_size
    return [PlanMember(f"{name}.{wname}",
                       p_moe[wname].float().transpose(-1, -2),
                       hess.HessianState(Hst.H, count_t), xl,
                       x_count=last_counts, starved=starved,
                       names=[f"{name}.{wname}[{ei}]" for ei in range(e)])
            for wname, Hst, xl in (("w_gate", H_in, x_last_in),
                                   ("w_up", H_in, x_last_in),
                                   ("w_down", H_mid, x_last_mid))]


def plan_layer(cfg: Config, step: LayerStep, cap: CaptureResult,
               report: Optional[QuantReport] = None,
               stats: Optional[Dict] = None,
               spec_routes: Optional[List[moe_mod.RoutePlan]] = None
               ) -> Tuple[Dict, List[str], qplan.QuantPlan]:
    """Stage (b): the captured dense linears and a routed-MoE layer's
    stacked experts → a QuantPlan (``report`` receives the layer's
    capacity drops, ``stats`` the walk's MoE counters; ``spec_routes``
    feeds the flip repair). Returns (a fresh copy of the layer subtree,
    the sorted dense names, the plan)."""
    new_params = _copy_tree(step.resolve_params())
    dense_names = sorted(cap.hessians)
    members = [PlanMember(name, _resolve(new_params, name)["w"].float().T,
                          cap.hessians[name], cap.last_x[name])
               for name in dense_names]
    if cap.is_moe:
        members += _moe_members(cfg, new_params["mlp"], cap.moe_xs, "mlp",
                                report, layer_name=step.name, stats=stats,
                                spec_routes=spec_routes)
    return new_params, dense_names, qplan.build_plan(cfg.quant, members)


def _scatter_moe(p_moe: Dict, results: Dict[str, MemberResult],
                 name: str) -> Dict:
    """The stacked expert weights (and their grids) from their members'
    results; a skipped member keeps its float weights."""
    new = dict(p_moe)
    for wname in _MOE_WNAMES:
        res = results[f"{name}.{wname}"]
        if res.w_q is None:
            continue
        new[wname] = res.w_q.transpose(-1, -2).to(
            p_moe[wname].dtype).contiguous()
        if res.grid is not None:
            new[f"{wname}_qscales"], new[f"{wname}_qzeros"] = res.grid
    return new


def scatter_layer(new_params: Dict, dense_names: List[str],
                  cap: CaptureResult,
                  results: Dict[str, MemberResult]) -> Dict:
    """Stage (d, first half): write on-grid weights (+ the stage-1 grid,
    for exact int4 packing) back into the subtree."""
    for name in dense_names:
        res = results[name]
        if res.w_q is None:
            continue                                # skipped: keep float
        node = _resolve(new_params, name)
        node["w"] = res.w_q.T.to(node["w"].dtype).contiguous()
        if res.grid is not None:
            node["qscales"], node["qzeros"] = res.grid
    if cap.is_moe:
        new_params["mlp"] = _scatter_moe(new_params["mlp"], results, "mlp")
    return new_params


def propagate_layer(step: LayerStep, new_params: Dict, hs: List[Tensor]
                    ) -> List[Tensor]:
    """Stage (d, second half): re-run the layer with its quantized params."""
    with torch.no_grad():
        return [step.apply_fn(new_params, h, bi) for bi, h in enumerate(hs)]


def _walker_decoder_only(cfg: Config, params: Dict, calib: List[Dict],
                         device: torch.device) -> LayerWalker:
    mc = cfg.model
    # a batch's frontend embeds (pixtral's patches) go in front of its
    # tokens, as at prefill
    hs = [T.embed_inputs(mc, params, b["tokens"].to(device),
                         b.get("embeds"))
          for b in calib]
    if len({h.shape[1] for h in hs}) != 1:
        raise ValueError("calibration batches must share seq_len")
    b0, s0, _ = hs[0].shape
    positions = T.positions_for(b0, s0, device)

    def apply_fn(spec):
        return lambda p, h, bi: T.layer_forward(mc, spec, p, h, positions)

    collected: List[Optional[Dict]] = [None] * len(params["layers"])
    items = [LayerStep(name=f"layer {li + 1}",
                       params=(lambda _li=li: params["layers"][_li]),
                       apply_fn=apply_fn(spec), hs_slot="h",
                       store=(lambda p, _li=li:
                              collected.__setitem__(_li, p)))
             for li, spec in enumerate(T.layer_specs(mc))]

    def finalize() -> Dict:
        out = dict(params)
        out["layers"] = collected
        return out

    return LayerWalker(streams={"h": hs}, items=items, finalize=finalize)


def _walker_encdec(cfg: Config, params: Dict, calib: List[Dict],
                   device: torch.device) -> LayerWalker:
    """The encoder-decoder's walk: the encoder steps on the ``enc`` stream
    (frames plus their sinusoidal positions), the ``enc→dec`` switch (the
    quantized encoder's final norm becomes each batch's cross-attention
    memory, and the ``dec`` stream of token embeddings plus positions
    opens), then the decoder steps. A decoder step calibrates its
    ``xattn`` linears only: its self-attention and MLP sit under its
    ``layer`` key, which the JAX package's capture does not pick (they
    are packed on a fresh grid)."""
    mc = cfg.model
    dtype = T.compute_dtype(mc)
    hs = [T.with_positions(mc, b["frames"].to(device=device, dtype=dtype))
          for b in calib]
    dhs = [T.decoder_inputs(mc, params, b["tokens"].to(device))
           for b in calib]
    if len({h.shape[1] for h in hs}) != 1 or \
            len({h.shape[1] for h in dhs}) != 1:
        raise ValueError("calibration batches must share their frame and "
                         "token lengths")
    b0 = hs[0].shape[0]
    enc_pos = T.positions_for(b0, hs[0].shape[1], device)
    dec_pos = T.positions_for(b0, dhs[0].shape[1], device)
    enc, dec = params["encoder"], params["decoder"]
    enc_out: List[Tensor] = []

    def switch(streams: Dict[str, List[Tensor]]) -> None:
        enc_out[:] = [norm(mc, enc["final_norm"], h) for h in streams["enc"]]
        streams["dec"] = list(dhs)

    def steps(prefix, layers, slot, apply_fn, collected):
        return [LayerStep(name=f"{prefix} {i + 1}",
                          params=(lambda _i=i: layers[_i]),
                          apply_fn=apply_fn, hs_slot=slot,
                          store=(lambda p, _i=i:
                                 collected.__setitem__(_i, p)))
                for i in range(len(layers))]

    enc_done: List[Optional[Dict]] = [None] * len(enc["layers"])
    dec_done: List[Optional[Dict]] = [None] * len(dec["layers"])
    items = steps("enc", enc["layers"], "enc",
                  lambda p, h, bi: T.encoder_layer(mc, p, h, enc_pos),
                  enc_done)
    items.append(StreamSwitch(name="enc→dec", run=switch))
    items += steps("dec", dec["layers"], "dec",
                   lambda p, h, bi: T.decoder_layer(mc, p, h, dec_pos,
                                                    enc_out[bi]),
                   dec_done)

    def finalize() -> Dict:
        out = dict(params)
        out["encoder"] = {"layers": enc_done,
                          "final_norm": enc["final_norm"]}
        out["decoder"] = {"layers": dec_done,
                          "final_norm": dec["final_norm"]}
        return out

    return LayerWalker(streams={"enc": hs}, items=items, finalize=finalize)


_MESH_FROM_CONFIG = object()     # sentinel: resolve the quant.mesh knob


def quantize_model(cfg: Config, params: Dict, calib: List[Dict[str, Tensor]],
                   device: Union[str, torch.device, None] = None,
                   verbose: bool = False, mesh=_MESH_FROM_CONFIG
                   ) -> Tuple[Dict, QuantReport]:
    """Quantize every layer of a decoder-only or encoder-decoder model
    (GPTQ + RPIQ).

    ``calib``: batch dicts ``{"tokens": (B, S), "embeds"?: (B, F, D)}``
    (frontend embeddings, prepended to the tokens), or for an
    encoder-decoder ``{"tokens": (B, S), "frames": (B, Se, D)}``; the last
    batch is the single instance of stage 2. Runs on the CUDA card unless
    ``device="cpu"``; params and tokens are moved there. Returns float
    params whose quantized linears hold on-grid values (with their
    ``qscales``/``qzeros``), and the :class:`QuantReport`.

    ``mesh``: a ``DeviceMesh`` (``launch/mesh.make_host_mesh``) for
    sharded group execution, or None for one device; left unset, the
    ``quant.mesh`` knob is resolved through ``launch/mesh.
    make_quant_mesh`` (under torchrun it starts the process group; a spec
    it cannot honour prints why and runs on one device, as the JAX
    package does). Under a mesh rank 0's params and batches are broadcast
    to every rank first, and only rank 0 prints the walk.
    """
    dev = resolve_device(device)
    t_start = time.perf_counter()
    report = QuantReport()
    if mesh is _MESH_FROM_CONFIG:
        from repro_torch.launch.mesh import make_quant_mesh
        mesh = make_quant_mesh(cfg.quant.mesh, device=dev)
    params = _to_device(params, dev)
    if mesh is not None:
        from repro_torch.distributed.sharding import broadcast_tree
        params = broadcast_tree(params)
        calib = broadcast_tree(calib)
        verbose = verbose and dist.get_rank() == 0
    build = (_walker_encdec if cfg.model.is_encoder_decoder
             else _walker_decoder_only)
    walker = build(cfg, params, calib, dev)
    out = qstream.run_walker(cfg, walker, report, verbose=verbose,
                             mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    report.seconds_total = time.perf_counter() - t_start
    return out, report


def pack_for_serving(cfg: Config, params_q: Dict) -> Dict:
    """Replace quantized-linear float weights with int4 QuantizedTensors.

    Packing reuses the stage-1 grid each quantized linear carries
    (``qscales``/``qzeros``), so the refined on-grid weights round-trip
    exactly; a weight without a grid gets a fresh one (an encoder-decoder's
    decoder self-attention and MLP, which calibration does not pick, as in
    the JAX package). The codes are
    rounded and packed by ``ops.quant_pack`` (asymmetric 4-bit grid, the
    layout of ``core.quant.pack_int4``). A stacked expert weight (E, in,
    out) packs as one (E·out, in) matrix on its ``{name}_qscales`` /
    ``{name}_qzeros`` grid into a ``QuantizedTensor`` with a leading
    expert axis. Norms, embeddings, lm_head and a MoE router stay float;
    so does an MTP head's ``mtp.proj``, while its ``mtp.layer`` linears,
    under a ``mixer`` / ``mlp`` key but never calibrated, are packed on a
    fresh grid (the reference's walk).
    """
    qc = cfg.quant

    def pack(w: Tensor, scales=None, zeros=None) -> QuantizedTensor:
        """(..., in, out) float → (..., out, in/2) packed; the leading
        dims (an expert axis) fold into the rows."""
        w_oi = w.float().transpose(-1, -2)
        lead, (o, i) = w_oi.shape[:-2], w_oi.shape[-2:]
        w2 = w_oi.reshape(-1, i)
        if scales is not None:
            qp = QuantParams(scales.float().reshape(w2.shape[0], -1),
                             zeros.float().reshape(w2.shape[0], -1))
        else:
            qp = compute_qparams(w2, qc.bits, qc.group_size)
        packed = ops.quant_pack(w2, qp.scales, qp.zeros,
                                group_size=qc.group_size)
        g = qp.scales.shape[-1]
        return QuantizedTensor(packed.reshape(*lead, o, i // 2),
                               qp.scales.reshape(*lead, o, g),
                               qp.zeros.reshape(*lead, o, g),
                               (*lead, o, i), qc.bits, qc.group_size)

    def walk(tree, path=""):
        if isinstance(tree, list):
            return [walk(v, path) for v in tree]
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if k in ("qscales", "qzeros") or k.endswith(("_qscales",
                                                          "_qzeros")):
                continue                      # consumed by the packer
            if (k == "w" and isinstance(v, Tensor) and v.dim() == 2
                    and any(s in path for s in _QUANT_SUBTREES)
                    and v.shape[0] % qc.group_size == 0
                    and "router" not in path):
                out[k] = pack(v, tree.get("qscales"), tree.get("qzeros"))
            elif (k in _MOE_WNAMES and isinstance(v, Tensor)
                  and v.dim() >= 3 and v.shape[-2] % qc.group_size == 0):
                out[k] = pack(v, tree.get(f"{k}_qscales"),
                              tree.get(f"{k}_qzeros"))
            else:
                out[k] = walk(v, f"{path}.{k}")
        return out

    return walk(params_q)
