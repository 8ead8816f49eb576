"""Quantization launcher: calibrate → GPTQ → RPIQ → packed artifact.

    PYTHONPATH=src python -m repro_torch.launch.quantize --arch opt-proxy \
        --smoke quant.rpiq_iters=5 quant.rpiq_alpha=0.01 [--device cpu]

The twin of the JAX package's ``launch/quantize.py``, with the same
command line. When ``train.ckpt_dir`` holds a step checkpoint (the
port's ``launch.train``'s or a JAX trainer's: they share the TrainState
layout) the parameters of its latest step are quantized (a *trained*
model); otherwise a fresh init from seed 0. Calibration is
``MarkovLM(vocab, seed=7)``: ``quant.calib_batches`` batches of
``quant.calib_batch_size`` × ``quant.calib_seq_len`` tokens; an
encoder-decoder (whisper) also gets ``encoder_seq_len`` standard-normal
frames a row in every batch, batch i drawn from a ``torch.Generator``
seeded i (the JAX launcher draws them from ``PRNGKey(i)``: torch cannot
reproduce ``jax.random`` bits, so the two launchers calibrate on other
frames). Writes
``<out>/<name>.report.json`` (one record per linear) and the packed int4
params ``<out>/<name>.params.pkl`` beside its sha256 sidecar, which
``launch.serve --params`` verifies at load.

``quant.ckpt_dir=<dir> quant.resume=auto`` checkpoints the layer walk at
every step, so a killed run restarts at the first incomplete layer with
an artifact bitwise that of an uninterrupted run (core/stream.py).
``faults.arm=<site@trigger[:mode],...>`` (and ``faults.seed``) arms the
fault plane (core/faults.py) for the run, e.g.
``faults.arm=hessian.cholesky@1:nan`` drives the guardrail ladder
(``quant.guardrail``, ``guardrail_retries``, ``guardrail_damp_factor``).
``quant.pipeline=overlap`` runs the layer walk's second schedule (the next
layer's capture ahead on a side CUDA stream, core/stream.py), bitwise the
serial artifact; the walk's counters are printed (``[quantize] pipeline:
{...}``). ``quant.batched_executor=false`` is not ported and raises.

``quant.mesh=DxM`` / ``DxMxE`` / ``auto`` shards the plan's groups over a
``torch.distributed`` world (``launch/mesh.py``, core/plan.py), started
by torchrun, one process a rank::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.quantize --arch opt-proxy --smoke \
        --device cpu quant.mesh=2x1

Every rank quantizes and packs; the ranks' packed artifacts are compared
by digest (``checkpoint.tree_digest``, a mismatch raises) and rank 0
alone prints the walk and writes the artifact, the report and the step
checkpoints. On one card the ranks share it over gloo.

Runs on the CUDA card; ``--device cpu`` runs the kernels' plain versions.
Before the write it prints this process's kernel launches (``[quantize]
kernel launches: {...}``, ``ops.kernel_launches``; zero on the CPU), so
that a caller in another process can see its kernels ran.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.config import apply_overrides, parse_overrides
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import faults
from repro_torch.core.pipeline import pack_for_serving, quantize_model
from repro_torch.data import MarkovLM, calibration_batches
from repro_torch.device import resolve_device
from repro_torch.distributed.checkpoint import (Checkpointer, restore_like,
                                                save_artifact, tree_digest,
                                                tree_from_paths, tree_paths)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (init_from_env, make_quant_mesh,
                                     mesh_sizes, rank)
from repro_torch.models import transformer as T

# a JAX TrainState's parameters: its NamedTuple field ``params``
_PARAMS = ".params/"


def trained_params(ckpt_dir: str, like: Dict,
                   device: torch.device) -> Optional[Dict]:
    """The parameters of the latest step checkpoint in ``ckpt_dir``, in the
    port's layout and in ``like``'s shapes and dtypes; None if there is no
    checkpoint. A leaf missing or of another shape than ``like``'s raises."""
    if not os.path.isdir(ckpt_dir):
        return None
    ckpt = Checkpointer(ckpt_dir)
    if ckpt.latest_step() is None:
        return None
    arrays, _ = ckpt.load_arrays()
    flat = {k[len(_PARAMS):]: v for k, v in arrays.items()
            if k.startswith(_PARAMS)}
    if not flat:
        raise KeyError(f"{ckpt_dir}: checkpoint holds no {_PARAMS!r} "
                       "leaves (a trainer's TrainState)")
    tree = params_from_numpy(tree_from_paths(flat))
    return restore_like(dict(tree_paths(tree)), like, device)


def main(argv=None):
    # olmoe-1b-7b's walk peaks within ~8 GiB of an 80 GB card, and under
    # the overlap schedule blocks freed on one stream are cached for it
    # alone: segments that grow in place keep them from stranding memory
    # (read when the allocator starts; the caller's own setting wins)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="artifacts/quantized")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    apply_overrides(cfg, parse_overrides(args.overrides))
    mc, qc = cfg.model, cfg.quant
    dev = resolve_device(args.device)
    started = init_from_env(dev)
    mesh = make_quant_mesh(qc.mesh, device=dev)
    # under a mesh rank 0 speaks for the world
    say = print if rank() == 0 else (lambda *a, **k: None)
    faults.install_from_config(cfg)
    if cfg.faults.arm:
        say(f"[quantize] fault plane armed: {cfg.faults.arm}")
    if qc.ckpt_dir:
        say(f"[quantize] step checkpoints → {qc.ckpt_dir} "
            f"(quant.resume={qc.resume})")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = (T.init_encdec_params(mc, gen, dev) if mc.is_encoder_decoder
              else T.init_params(mc, gen, dev))
    trained = trained_params(cfg.train.ckpt_dir, params, dev)
    if trained is not None:
        params = trained
        say(f"[quantize] loaded checkpoint step "
            f"{Checkpointer(cfg.train.ckpt_dir).latest_step()}")

    data = MarkovLM(mc.vocab_size, seed=7)
    calib = calibration_batches(data, qc.calib_batches, qc.calib_batch_size,
                                min(qc.calib_seq_len, mc.max_seq_len - 8))
    if mc.is_encoder_decoder:
        for i, b in enumerate(calib):
            frames_gen = torch.Generator()
            frames_gen.manual_seed(i)
            b["frames"] = torch.randn(
                (qc.calib_batch_size, mc.encoder_seq_len, mc.d_model),
                generator=frames_gen)
    if mesh is not None:
        say(f"[quantize] sharded group execution on mesh "
            f"{mesh_sizes(mesh)}")
    params_q, report = quantize_model(cfg, params, calib, device=dev,
                                      verbose=True, mesh=mesh)
    del params
    say(f"[quantize] {report.summary()}")
    if report.pipeline_stats.get("resumed_at") is not None:
        say(f"[quantize] resumed from checkpoint at walk item "
            f"{report.pipeline_stats['resumed_at']}")
    if report.guardrail_stats:
        say(f"[quantize] guardrail: {report.guardrail_stats}")
    say(f"[quantize] pipeline: {report.pipeline_stats}")
    packed = pack_for_serving(cfg, params_q)
    if mesh is not None:
        digests = [None] * dist.get_world_size()
        dist.all_gather_object(digests, tree_digest(packed))
        if len(set(digests)) != 1:
            raise RuntimeError(f"the ranks' packed artifacts differ: "
                               f"sha256 {digests}")
        say(f"[quantize] {len(digests)} ranks' packed artifacts bitwise "
            f"equal (sha256 {digests[0]})")
    say(f"[quantize] kernel launches: {json.dumps(ops.kernel_launches())}")
    path = os.path.join(args.out, f"{mc.name}.params.pkl")
    if rank() == 0:
        _write(args.out, mc.name, report, packed)
    if started:
        dist.destroy_process_group()
    return path, report


def _write(out: str, tag: str, report, packed) -> None:
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{tag}.report.json"), "w") as f:
        json.dump([{**vars(r)} for r in report.linears], f, indent=1)
    # atomic write + sha256 sidecar: launch.serve verifies the digest at
    # load, so a flipped byte in the artifact is a typed error
    save_artifact(os.path.join(out, f"{tag}.params.pkl"), packed,
                  extra={"arch": tag})
    print(f"[quantize] wrote {out}/{tag}.params.pkl (+ integrity "
          "manifest)")


if __name__ == "__main__":
    main()
