"""Serving launcher: batched greedy generation with (optionally int4) weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-proxy \
        --smoke --prompt-len 32 --batch 4 serve.max_new_tokens=16 \
        [--device cpu]

The twin of the JAX package's ``launch/serve.py``, with the same command
line. ``--params`` loads a ``launch.quantize`` artifact through the
integrity-checked ``distributed.checkpoint.load_artifact`` (a corrupt
artifact is a typed ``ArtifactIntegrityError``, never a silent load);
``--pack-rtn`` packs float weights (a fresh init from seed 0, or the
loaded ones) to int4 on a fresh grid, so the quantized decode runs
without a quantize run. Prompts are ``MarkovLM(vocab, seed=3)``; an
encoder-decoder (``whisper-large-v3``) also gets ``encoder_seq_len``
standard-normal frames a request for its encoder, and another model with
a frontend (``pixtral-12b``) ``min(frontend_tokens, 8)`` standard-normal
patch embeddings a request, prepended to the prompt; both are drawn from
a ``torch.Generator`` seeded 3 like the prompt (the JAX launcher draws
them from ``jax.random``, whose bits torch cannot reproduce). The static
batch runs through ``serving.engine.generate``, whose decode replays one
captured CUDA graph on the card; ``serve.prefill_chunk=<n>`` prefills
``n`` positions at a time.

``serve.scheduler=continuous`` submits the same prompts one by one to the
continuous engine (``serving/scheduler.ContinuousEngine``: ``serve.
max_batch`` decode lanes, chunked prefill, deadlines, NaN quarantine) and
drains it; ``serve.supervise=true`` wraps it in the crash-recovering
``serving/supervisor.SupervisedEngine`` (``serve.max_restarts``,
``serve.step_timeout_s``), which re-reads a ``--params`` artifact through
the integrity check at each rebuild. ``faults.arm=<site@trigger[:mode],
...>`` arms the fault plane (core/faults.py) for the run, e.g.
``faults.arm=serve.engine_step@3``.

Runs on the CUDA card; ``--device cpu`` runs the kernels' plain versions.
The last line is this process's kernel launches (``[serve] kernel
launches: {...}``, ``ops.kernel_launches``; zero on the CPU).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.config import apply_overrides, parse_overrides
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import faults
from repro_torch.core.pipeline import pack_for_serving
from repro_torch.data import MarkovLM
from repro_torch.device import resolve_device
from repro_torch.distributed.checkpoint import load_artifact
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.serving.engine import generate
from repro_torch.serving.scheduler import ContinuousEngine
from repro_torch.serving.supervisor import SupervisedEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--params", default=None,
                    help="packed params artifact from launch.quantize")
    ap.add_argument("--pack-rtn", action="store_true",
                    help="RTN-pack weights to int4 QuantizedTensor before "
                         "serving (no quantize run needed)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    apply_overrides(cfg, parse_overrides(args.overrides))
    mc, sc = cfg.model, cfg.serve
    if sc.scheduler not in ("static", "continuous"):
        raise ValueError(f"serve.scheduler must be 'static' or "
                         f"'continuous', got {sc.scheduler!r}")
    dev = resolve_device(args.device)
    faults.install_from_config(cfg)
    if cfg.faults.arm:
        print(f"[serve] fault plane armed: {cfg.faults.arm}")

    if args.params:
        params = params_from_numpy(load_artifact(args.params), dev)
        print(f"[serve] loaded int4 params from {args.params} "
              "(integrity-checked)")
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = (T.init_encdec_params(mc, gen, dev)
                  if mc.is_encoder_decoder else T.init_params(mc, gen, dev))
    if args.pack_rtn:
        params = pack_for_serving(cfg, params)
        print("[serve] RTN-packed weights to int4")

    batch = MarkovLM(mc.vocab_size, seed=3).batch(args.batch,
                                                  args.prompt_len)
    gen = torch.Generator()
    gen.manual_seed(3)
    # an encoder-decoder's frontend (whisper's audio) feeds its encoder,
    # not the front of the prompt
    if mc.is_encoder_decoder:
        batch["frames"] = torch.randn(
            (args.batch, mc.encoder_seq_len, mc.d_model), generator=gen)
    elif mc.frontend in ("vision", "audio") and mc.frontend_tokens:
        batch["embeds"] = torch.randn(
            (args.batch, min(mc.frontend_tokens, 8), mc.d_model),
            generator=gen)
    t0 = time.perf_counter()
    if sc.scheduler == "continuous":
        n_front = batch["embeds"].shape[1] if "embeds" in batch else 0
        cap = args.prompt_len + n_front + sc.max_new_tokens + 1
        if sc.supervise:
            # a --params path of packed weights goes down to the
            # supervisor, so a rebuild re-reads the artifact through the
            # integrity check (with --pack-rtn the artifact holds the float
            # weights, which a rebuild must not serve)
            path = args.params if args.params and not args.pack_rtn else None
            eng = SupervisedEngine(cfg, params, max_len=cap,
                                   params_path=path, device=dev)
            print(f"[serve] supervised engine (max_restarts="
                  f"{sc.max_restarts}, step_timeout_s={sc.step_timeout_s})")
        else:
            eng = ContinuousEngine(cfg, params, max_len=cap, device=dev)
        rids = [eng.submit({k: v[i:i + 1] for k, v in batch.items()})
                for i in range(args.batch)]
        done = eng.run()
        seqs = [done[r].tokens for r in rids]
        toks = int(sum(len(q) for q in seqs))
        bad = {r: done[r].status for r in rids if done[r].status != "ok"}
        if bad:
            print(f"[serve] non-ok requests: {bad}")
        stats = eng.engine_stats()
        if bad or any(stats.values()):
            print(f"[serve] engine stats: {stats}")
        res = done
    else:
        res = generate(cfg, params, batch, device=dev)
        seqs = res.tokens.cpu()
        toks = int(seqs.numel())
    dt = time.perf_counter() - t0
    print(f"[serve] scheduler={sc.scheduler}: {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s incl. kernel build and graph capture)")
    for i in range(min(args.batch, 4)):
        print(f"  seq{i}: {list(map(int, seqs[i]))}")
    print(f"[serve] kernel launches: {json.dumps(ops.kernel_launches())}")
    return res

if __name__ == "__main__":
    main()
