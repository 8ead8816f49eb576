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
     b. **plan** — group the captured linears by shape class;
     c. **execute** — stage 1 (GPTQ) and stage 2 (RPIQ) per group;
     d. **scatter** the on-grid weights and their stage-1 grid back into
        the layer, then **propagate** the quantized layer's outputs to the
        next layer, so later Hessians see the quantized network.

An encoder-decoder walks its encoder layers on the encoder stream, then,
behind a :class:`~repro_torch.core.stream.StreamSwitch` fence, its decoder
layers on the decoder stream (:func:`_walker_encdec`).

:func:`pack_for_serving` then turns every quantized linear into an int4
:class:`~repro_torch.core.quant.QuantizedTensor` on its stage-1 grid,
through the ``quant_pack`` kernel on the card.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch.config import Config
from repro_torch.core import hessian as hess
from repro_torch.core import plan as qplan
from repro_torch.core import stream as qstream
from repro_torch.core.plan import MemberResult, PlanMember, QuantReport
from repro_torch.core.quant import (QuantizedTensor, QuantParams,
                                    compute_qparams)
from repro_torch.core.stream import LayerStep, LayerWalker, StreamSwitch
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.layers import norm
from repro_torch.models.linear import Tap

Tensor = torch.Tensor

# a layer's subtrees whose linears are calibrated (a layer's top-level keys,
# as the JAX package picks them); norms / embeddings / lm_head stay fp
_QUANT_SUBTREES = ("mixer", "mlp", "xattn")


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


@dataclasses.dataclass
class CaptureResult:
    """One layer's calibration state: Hessians and last-batch inputs."""
    hessians: Dict[str, hess.HessianState]
    last_x: Dict[str, Tensor]


def capture_layer(cfg: Config, step: LayerStep, hs: List[Tensor]
                  ) -> CaptureResult:
    """Stage (a): stream Hessians over all batches, keep the last inputs."""
    layer_params = step.resolve_params()
    targets = set()
    for sub in _QUANT_SUBTREES:
        if sub in layer_params:
            targets.update(f"{sub}.{n}"
                           for n in _linear_names_in(layer_params[sub]))
    hessians: Dict[str, hess.HessianState] = {}
    last_x: Dict[str, Tensor] = {}

    def on_record(name: str, x: Tensor) -> None:
        if name not in targets:
            return
        x2 = x.reshape(-1, x.shape[-1])
        if name not in hessians:
            hessians[name] = hess.init_hessian(x2.shape[1], device=x.device)
        hessians[name] = hess.accumulate(hessians[name], x2)
        last_x[name] = x2            # overwritten per batch: the last stays

    with torch.no_grad(), Tap(on_record=on_record):
        for bi, h in enumerate(hs):
            step.apply_fn(layer_params, h, bi)
    return CaptureResult(hessians, last_x)


def plan_layer(cfg: Config, step: LayerStep, cap: CaptureResult
               ) -> Tuple[Dict, List[str], qplan.QuantPlan]:
    """Stage (b): the captured dense linears → a QuantPlan. Returns (a
    fresh copy of the layer subtree, the sorted linear names, the plan)."""
    new_params = _copy_tree(step.resolve_params())
    dense_names = sorted(cap.hessians)
    members = [PlanMember(name, _resolve(new_params, name)["w"].float().T,
                          cap.hessians[name], cap.last_x[name])
               for name in dense_names]
    return new_params, dense_names, qplan.build_plan(cfg.quant, members)


def scatter_layer(new_params: Dict, dense_names: List[str],
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


def quantize_model(cfg: Config, params: Dict, calib: List[Dict[str, Tensor]],
                   device: Union[str, torch.device, None] = None,
                   verbose: bool = False) -> Tuple[Dict, QuantReport]:
    """Quantize every layer of a decoder-only or encoder-decoder model
    (GPTQ + RPIQ).

    ``calib``: batch dicts ``{"tokens": (B, S), "embeds"?: (B, F, D)}``
    (frontend embeddings, prepended to the tokens), or for an
    encoder-decoder ``{"tokens": (B, S), "frames": (B, Se, D)}``; the last
    batch is the single instance of stage 2. Runs on the CUDA card unless
    ``device="cpu"``; params and tokens are moved there. Returns float
    params whose quantized linears hold on-grid values (with their
    ``qscales``/``qzeros``), and the :class:`QuantReport`.
    """
    dev = resolve_device(device)
    t_start = time.perf_counter()
    report = QuantReport()
    params = _to_device(params, dev)
    build = (_walker_encdec if cfg.model.is_encoder_decoder
             else _walker_decoder_only)
    walker = build(cfg, params, calib, dev)
    out = qstream.run_walker(cfg, walker, report, verbose=verbose)
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
    layout of ``core.quant.pack_int4``). Norms, embeddings and lm_head stay
    float.
    """
    qc = cfg.quant

    def pack(w: Tensor, scales=None, zeros=None) -> QuantizedTensor:
        w_oi = w.float().T
        o, i = w_oi.shape
        if scales is not None:
            qp = QuantParams(scales.float(), zeros.float())
        else:
            qp = compute_qparams(w_oi, qc.bits, qc.group_size)
        packed = ops.quant_pack(w_oi, qp.scales, qp.zeros,
                                group_size=qc.group_size)
        return QuantizedTensor(packed, qp.scales, qp.zeros, (o, i), qc.bits,
                               qc.group_size)

    def walk(tree, path=""):
        if isinstance(tree, list):
            return [walk(v, path) for v in tree]
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if k in ("qscales", "qzeros"):
                continue                      # consumed by the packer
            if (k == "w" and isinstance(v, Tensor) and v.dim() == 2
                    and any(s in path for s in _QUANT_SUBTREES)
                    and v.shape[0] % qc.group_size == 0):
                out[k] = pack(v, tree.get("qscales"), tree.get("qzeros"))
            else:
                out[k] = walk(v, f"{path}.{k}")
        return out

    return walk(params_q)
