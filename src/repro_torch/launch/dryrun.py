"""Shape-only dry run: every (arch x shape x mesh) cell traced on fake
tensors, the twin of the JAX package's ``src/repro/launch/dryrun.py``
(``lower_cell`` :49, ``lower_quant_cell`` :111, ``main`` :226)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out artifacts/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --quant-cell \\
        --arch deepseek-v3-671b --quant-mesh 1x2x256
    PYTHONPATH=src python -m repro_torch.launch.dryrun --quant-walk \\
        --arch recurrentgemma-9b --layers 33,38 --calib 4x4x512

The JAX package lowers each cell on a forced 512-device host and reads
``memory_analysis()``, FLOPs, bytes and collectives from the compiled HLO.
Here this process stands in for rank 0 of a world of 256 or 512 ranks on
torch's ``fake`` process-group backend (``launch/mesh.fake_world``), its
tensors are ``FakeTensorMode`` tensors on the card's device (shapes and
dtypes, no memory; on the CPU where torch has no CUDA,
``launch/cost.fake_device``), and ``launch/cost.CostCounter`` counts what
one step runs. It
allocates nothing, needs no card and sets no environment; the entry
points that run for real stay on the card by default.

Each cell writes ``<out>/<arch>__<shape>__<mesh>.json``: the JAX
artifact's keys where their meaning carries over (``launch/cost.
cost_terms``) and each rank's peak against the card's 80 GB; a cell that
would not fit is reported, not refused.

- train cells trace ``make_sharded_train_step``'s forward, backward and
  AdamW on the rank's blocks of the train state (the global batch in):
  the ``model`` axis computes its share (attention by heads where the
  heads and kv-heads divide it, or by q-heads over one kv-head a rank
  where the axis is a multiple of the kv-heads; MLA by heads, its
  latents whole; the dense MLP by ``d_ff``; Mamba by ``d_inner``, its
  [u | z] in projection re-blocked by an all-to-all; RG-LRU by
  ``lru_width``, its u all-gathered for rg / ig; routed experts by E,
  the routing whole; the MTP projection by its output columns, the MTP
  layer as the main layers; the embedding, head and loss by vocab), so a
  rank's FLOPs, peak and model-axis collectives are its share's;
- prefill cells gather the whole parameters and run ``T.prefill`` (an
  encoder-decoder's ``encdec_prefill``) on the rank's batch block (their
  model-axis split is item 26);
- decode cells gather the parameters (int4-packed unless
  ``--fp-decode``) and run the eager ``serve_step`` on the rank's batch
  block and caches, never a captured CUDA graph;
- ``--quant-cell`` traces the capture → quantize → serve chain of a
  routed-MoE arch as ``lower_quant_cell`` lowers it: one MoE layer's
  calibration capture (routing, the (E, C, d) scatter, the stacked
  per-expert Hessians), stage 1 and stage 2 (``core/plan.stage1`` /
  ``stage2``) of the (E, f, d) gate/up expert slab on this rank's (lane,
  row) block of the ``DxMxE`` quant mesh, as the sharded executor holds
  it (the whole slab, this rank's lanes of the Hessians), and the
  quantized decode step on the 512-rank production mesh.

``--quant-walk`` (:func:`quant_walk`) traces a whole quantization walk
(``quantize_model``'s serial schedule, its steps from ``core/pipeline``)
on one card at each of ``--layers`` depths, for the memory a depth needs;
each writes ``<out>/<arch>__quantwalk__<layers>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Tuple

import torch

from repro_torch.config import Config, apply_overrides, parse_overrides
from repro_torch.configs.registry import (ARCH_IDS, SHAPES, ShapeSpec,
                                          get_config, shape_names_for)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import cost
from repro_torch.launch.mesh import (fake_world, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.specs import close_packed, input_specs
from repro_torch.models import transformer as T


def _step(cfg: Config, shape: ShapeSpec, rules: shd.Rules,
          spec: Dict[str, Any]):
    """The cell's step as a zero-argument call on ``spec``'s trees."""
    mc, mesh = cfg.model, rules.mesh
    if shape.kind == "train":
        from repro_torch.training.train_step import make_sharded_train_step
        step = make_sharded_train_step(cfg, rules, spec["state_specs"])
        return lambda: step(spec["state"], spec["batch"])

    def whole_params():
        return close_packed(shd.gather(spec["params"], spec["param_specs"],
                                       mesh), spec["packed_meta"])

    if shape.kind == "prefill":
        def prefill():
            params, b = whole_params(), spec["batch"]
            with torch.no_grad():
                if mc.is_encoder_decoder:
                    return T.encdec_prefill(mc, params, b["frames"],
                                            b["tokens"], shape.seq_len)
                return T.prefill(mc, params, b["tokens"], shape.seq_len,
                                 embeds=b.get("embeds"))
        return prefill

    from repro_torch.serving.engine import serve_step

    def decode():
        with torch.no_grad():
            return serve_step(cfg, whole_params(), spec["token"],
                              spec["pos"], spec["caches"])
    return decode


def trace_cell(cfg: Config, shape: ShapeSpec, rules: shd.Rules,
               quantized_decode: bool = True
               ) -> Tuple[cost.CostCounter, float]:
    """Build the cell's fake inputs (this rank's blocks) and count one step
    on them; ``(counter, wall of the counted step)``. Runs inside the
    caller's fake world."""
    with cost.fake_mode():
        spec = input_specs(cfg, shape, rules,
                           quantized_decode=quantized_decode)
        step = _step(cfg, shape, rules, spec)
        args = {k: v for k, v in spec.items()
                if k in ("state", "params", "batch", "token", "pos",
                         "caches")}
        t0 = time.perf_counter()
        with cost.CostCounter(args) as cc:
            out = step()
            del out
        wall = time.perf_counter() - t0
    return cc, wall


def _groups_ready(mesh):
    """``mesh`` with every dim's process group looked up now: the lookup
    reads the mesh's (real) rank grid, which no op may touch under the
    fake mode."""
    for name in mesh.mesh_dim_names:
        shd.axis_group(mesh, name)
    return mesh


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides=None, quantized_decode: bool = True
               ) -> Dict[str, Any]:
    """Trace one cell on the production mesh; returns the artifact dict."""
    cfg = get_config(arch)
    if overrides:
        apply_overrides(cfg, overrides)
    shape = SHAPES[shape_name]
    n_dev = 512 if multi_pod else 256
    with fake_world(n_dev):
        rules = shd.make_rules(_groups_ready(
            make_production_mesh(multi_pod=multi_pod)), cfg.parallel)
        cc, wall = trace_cell(cfg, shape, rules, quantized_decode)
    terms = cost.cost_terms(cc, n_dev,
                            model_flops=cost.model_flops_estimate(cfg, shape))
    terms.update({
        "arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
        "seconds_trace": wall,
        "quantized_decode": bool(shape.kind == "decode"
                                 and quantized_decode),
        "total_params": cost.total_param_count(cfg.model),
        "active_params": cost.active_param_count(cfg.model),
    })
    return terms


_LEG_KEYS = ("per_device_flops", "per_device_bytes", "kernel_calls",
             "collectives", "memory_analysis", "fits_80gb", "dominant")


def _leg(art: Dict[str, Any], name: str, args: Any, fn) -> Any:
    """Count ``fn()`` as one leg of a quant cell: its wall, per-rank peak,
    FLOPs, bytes, kernel calls and collectives under ``<name>_*`` keys."""
    t0 = time.perf_counter()
    with cost.CostCounter(args) as cc:
        out = fn()
    wall = time.perf_counter() - t0
    terms = cost.cost_terms(cc, 1)
    art[f"{name}_seconds_trace"] = wall
    for k in _LEG_KEYS:
        art[f"{name}_{k}"] = terms[k]
    art[f"{name}_kernel_shapes"] = [[op, list(shapes)]
                                    for op, shapes, _ in cc.kernel_log]
    peak = terms["memory_analysis"]["peak_memory_in_bytes"]
    print(f"[dryrun] quant-cell {art['arch']} {name}: traced in {wall:.1f}s,"
          f" rank peak {peak} bytes, kernels {cc.kernels}", flush=True)
    return out


def lower_quant_cell(arch: str, quant_mesh: str = "1x2x256",
                     overrides=None, smoke: bool = False) -> Dict[str, Any]:
    """Trace the capture → quantize → serve chain of a routed-MoE arch
    (module docstring); each leg's figures under its own keys. ``smoke``:
    the arch's smoke config."""
    from repro_torch.core import hessian as hess
    from repro_torch.core import plan as qplan
    from repro_torch.core.gptq import GPTQResult
    from repro_torch.distributed.sharding import quant_group_sharding
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import _act

    cfg = get_config(arch, smoke=smoke)
    if overrides:
        apply_overrides(cfg, overrides)
    mc, qc = cfg.model, cfg.quant
    if mc.moe.num_experts <= 0:
        raise ValueError(f"{arch} has no routed experts")
    d_, m_, e_ = (int(p) for p in quant_mesh.lower().split("x"))
    e, d, f = mc.moe.num_experts, mc.d_model, mc.moe.d_ff_expert
    t = qc.calib_batch_size * qc.calib_seq_len     # flat tokens per batch
    cap = moe_mod._capacity(mc, t)
    wdt = T.compute_dtype(mc)
    art: Dict[str, Any] = {"arch": arch, "quant_mesh": quant_mesh,
                           "experts": e, "d_model": d, "d_ff_expert": f,
                           "calib_tokens": t, "capacity": cap}
    world = max(d_ * m_ * e_, 512)
    dev = cost.fake_device()
    fp32 = dict(dtype=torch.float32, device=dev)
    with fake_world(world):
        qmesh = _groups_ready(make_host_mesh(data=d_, model=m_, expert=e_))
        pmesh = _groups_ready(make_production_mesh(multi_pod=True))
        gshard = quant_group_sharding(qmesh, lanes=e, out_dim=f,
                                      expert_stacked=True)
        if gshard is None:
            raise ValueError(f"quant mesh {quant_mesh} shards nothing for "
                             f"(E={e}, out={f})")
        art["lane_axis"] = str(gshard.lane_axis)
        art["row_axis"] = str(gshard.row_axis)
        with cost.fake_mode():
            # -- capture: one MoE layer's calibration forward ----------------
            p_moe = {"router": {"w": torch.empty((d, e), **fp32)},
                     "w_gate": torch.empty((e, d, f), dtype=wdt,
                                           device=dev),
                     "w_up": torch.empty((e, d, f), dtype=wdt,
                                         device=dev),
                     "w_down": torch.empty((e, f, d), dtype=wdt,
                                           device=dev)}
            xt = torch.empty((t, d), dtype=wdt, device=dev)

            def capture():
                with torch.no_grad():
                    plan = moe_mod.route(mc, p_moe, xt)
                    buf = moe_mod.apply_route(plan, xt)
                    bf = buf.float()
                    mid = (_act(mc.act, torch.bmm(bf, p_moe["w_gate"].float()))
                           * torch.bmm(bf, p_moe["w_up"].float()))
                    h_in = hess.accumulate(hess.init_hessian(d, e, dev),
                                           buf)
                    h_mid = hess.accumulate(hess.init_hessian(f, e, dev),
                                            mid)
                    return h_in, h_mid, plan.counts
            _leg(art, "capture", (p_moe, xt), capture)
            del p_moe, xt

            # -- stage 1 and stage 2 on this rank's (lane, row) block -------
            w = torch.empty((e, f, d), **fp32)
            H = torch.empty((e, d, d), **fp32)
            count = torch.empty((e,), dtype=torch.int32, device=dev)
            local = hess.shard_stacked(hess.HessianState(H, count), gshard)
            del H
            damp = torch.full((local.H.shape[0],), qc.percdamp,
                              device=dev)

            def stage1():
                with torch.no_grad():
                    hd = hess.damped(local, damp)
                    return qplan.stage1(qc, w, hd, gshard), hd
            res1, hd = _leg(art, "stage1", (w, local), stage1)
            res1 = GPTQResult(*(r.clone() for r in res1))
            x = torch.empty((e, cap, d), **fp32)
            xc = torch.empty((e,), dtype=torch.int32, device=dev)

            def stage2():
                with torch.no_grad():
                    return qplan.stage2(qc, res1, w, x, hd, local.count, xc,
                                        gshard)
            _leg(art, "stage2", (res1, w, x, hd, local, xc), stage2)
            del res1, hd, w, x, local

        # -- serve: the quantized decode step on the production mesh --------
        rules = shd.make_rules(pmesh, cfg.parallel)
        cc, wall = trace_cell(cfg, SHAPES["decode_32k"], rules, True)
    terms = cost.cost_terms(cc, 512)
    art["serve_seconds_trace"] = wall
    for k in _LEG_KEYS:
        art[f"serve_{k}"] = terms[k]
    print(f"[dryrun] quant-cell {arch} serve: traced in {wall:.1f}s, rank "
          f"peak {terms['memory_analysis']['peak_memory_in_bytes']} bytes, "
          f"kernels {cc.kernels}", flush=True)
    return art


def quant_walk(arch: str, layers: int, calib_shape: Tuple[int, int, int],
               frontend: bool = True, overrides=None
               ) -> Tuple[cost.CostCounter, float]:
    """A whole quantization walk of ``arch`` cut to ``layers`` on one card,
    traced: the float params on the card, ``calib_shape`` (batches, rows,
    tokens) of calibration (a frontend's patch embeddings in each batch
    with ``frontend``), then ``quantize_model``'s serial schedule step by
    step (``core/pipeline``'s capture, plan, execute, scatter, propagate;
    the records deferred and never read, the ladder's host read off).
    Returns ``(counter, wall)``; its peak is the walk's, the params in
    it."""
    from repro_torch.core import pipeline as qpipe
    from repro_torch.core import plan as qplan

    cfg = get_config(arch)
    if overrides:
        apply_overrides(cfg, overrides)
    mc, qc = cfg.model, cfg.quant
    mc.num_layers = layers
    qc.guardrail = False        # its detector reads the card
    nb, rows, toks = calib_shape
    dev = cost.fake_device()
    with cost.fake_mode():
        params = T.init_params(mc, torch.Generator(), dev)
        calib = []
        for _ in range(nb):
            b = {"tokens": torch.empty((rows, toks), dtype=torch.int64,
                                       device=dev)}
            if frontend and mc.frontend_tokens:
                b["embeds"] = torch.empty((rows, mc.frontend_tokens,
                                           mc.d_model), device=dev)
            calib.append(b)
        t0 = time.perf_counter()
        with cost.CostCounter((params, calib)) as cc:
            walker = qpipe._walker_decoder_only(cfg, params, calib,
                                                torch.device(dev))
            report = qplan.QuantReport()
            for item in walker.items:
                hs = walker.streams[item.hs_slot]
                cap = qpipe.capture_layer(cfg, item, hs)
                new_params, names, plan = qpipe.plan_layer(cfg, item, cap,
                                                           report)
                results = qplan.execute_plan(qc, plan, report, sync=False,
                                             deferred=[])
                del plan
                qpipe.scatter_layer(new_params, names, cap, results)
                del results, cap
                walker.streams[item.hs_slot] = qpipe.propagate_layer(
                    item, new_params, hs)
                item.store(new_params)
                item.release_params()
                del hs, new_params
            out = walker.finalize()
            del walker, out
        wall = time.perf_counter() - t0
    return cc, wall


def walk_cells(arch: str, layers: str, calib: str, out: str,
               overrides=None) -> None:
    """``--quant-walk``: one artifact a depth (module docstring)."""
    cfg = get_config(arch)
    qc = cfg.quant
    depths = ([int(x) for x in layers.split(",")] if layers
              else [cfg.model.num_layers])
    shape = (tuple(int(x) for x in calib.lower().split("x")) if calib else
             (qc.calib_batches, qc.calib_batch_size, qc.calib_seq_len))
    os.makedirs(out, exist_ok=True)
    for n in depths:
        cc, wall = quant_walk(arch, n, shape, overrides=overrides)
        mem = cc.memory_analysis()
        art = {"arch": arch, "layers": n,
               "full_layers": cfg.model.num_layers,
               "calib": list(shape), "seconds_trace": wall,
               "memory_analysis": mem,
               "fits_80gb": mem["peak_memory_in_bytes"] <= cost.H100_MEMORY,
               "kernel_calls": cc.kernels, "aten_ops": cc.ops}
        path = os.path.join(out, f"{arch}__quantwalk__{n}.json")
        with open(path, "w") as fh:
            json.dump(art, fh, indent=1)
        print(f"[dryrun] {arch} quantization walk at {n} of "
              f"{cfg.model.num_layers} layers, calibration "
              f"{'x'.join(map(str, shape))}: peak {mem['peak_memory_in_bytes']}"
              f" bytes ({'fits' if art['fits_80gb'] else 'does not fit'} "
              f"80 GB; traced in {wall:.1f}s) → {path}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--fp-decode", action="store_true",
                    help="decode cells with bf16 (not int4) weights")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--quant-cell", action="store_true",
                    help="trace the capture→quantize→serve chain for the "
                         "given --arch instead of the forward cells")
    ap.add_argument("--quant-mesh", default="1x2x256",
                    help="DxMxE quant mesh for the --quant-cell stages "
                         "(expert-parallel lanes)")
    ap.add_argument("--quant-walk", action="store_true",
                    help="trace the given --arch's quantization walk on one "
                         "card at each of --layers")
    ap.add_argument("--layers", default="",
                    help="with --quant-walk: comma-separated depths "
                         "(default: the config's)")
    ap.add_argument("--calib", default="",
                    help="with --quant-walk: BATCHESxROWSxTOKENS "
                         "(default: the config's quant.calib_*)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.overrides)

    if args.quant_walk:
        if not args.arch:
            ap.error("--quant-walk requires --arch")
        walk_cells(args.arch, args.layers, args.calib, args.out, overrides)
        return

    if args.quant_cell:
        if not args.arch:
            ap.error("--quant-cell requires --arch")
        os.makedirs(args.out, exist_ok=True)
        tag = f"{args.arch}__quant__{args.quant_mesh}"
        try:
            art = lower_quant_cell(args.arch, args.quant_mesh, overrides)
        except Exception as e:
            print(f"[dryrun] {tag}: FAILED {e!r}", flush=True)
            traceback.print_exc()
            sys.exit(1)
        path = os.path.join(args.out, tag + ".json")
        with open(path, "w") as fh:
            json.dump(art, fh, indent=1)
        legs = [k[:-len("_seconds_trace")] for k in art
                if k.endswith("_seconds_trace")]
        print(f"[dryrun] {tag}: OK ({', '.join(legs)}) → {path}")
        return

    cells = []
    archs = [a for a in ARCH_IDS if a != "opt-proxy"] \
        if args.all or args.arch is None else [args.arch]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    for arch in archs:
        shapes = shape_names_for(arch) if args.shape is None \
            else [args.shape]
        cells += [(arch, s, mp) for s in shapes for mp in meshes]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, s, mp in cells:
        tag = f"{arch}__{s}__{_mesh_name(mp)}"
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            print(f"[dryrun] {tag}: cached")
            continue
        print(f"[dryrun] {tag}: tracing...", flush=True)
        try:
            art = lower_cell(arch, s, mp, overrides,
                             quantized_decode=not args.fp_decode)
            with open(path, "w") as fh:
                json.dump(art, fh, indent=1)
            peak = art["memory_analysis"]["peak_memory_in_bytes"]
            print(f"[dryrun] {tag}: OK  compute={art['t_compute_s']:.4f}s "
                  f"memory={art['t_memory_s']:.4f}s "
                  f"collective={art['t_collective_s']:.4f}s "
                  f"dominant={art['dominant']} rank peak {peak} bytes "
                  f"({'fits' if art['fits_80gb'] else 'does not fit'} "
                  f"80 GB; traced in {art['seconds_trace']:.1f}s)",
                  flush=True)
        except Exception as e:
            failures.append((tag, repr(e)))
            print(f"[dryrun] {tag}: FAILED {e!r}", flush=True)
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err[:200]}")
        sys.exit(1)
    print(f"\nall {len(cells)} cells passed")


if __name__ == "__main__":
    main()
