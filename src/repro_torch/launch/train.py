"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch opt-proxy \\
        train.steps=200 train.global_batch_size=16 [--smoke] [--device cpu]

The twin of the JAX package's ``launch/train.py``, with the same command
line: the model of ``--arch`` (``--smoke`` for its CPU-scale config)
trains on ``MarkovLM(vocab, seed=train.seed)`` for ``train.steps`` steps.
Checkpoints land in ``train.ckpt_dir`` in the JAX TrainState's layout, and
a rerun resumes from the latest one, the data stream's position included;
SIGTERM checkpoints at the next step boundary and exits.
``launch.quantize train.ckpt_dir=<dir>`` quantizes the trained weights.
``--mesh`` (sharded training) is not ported (ROADMAP.md queue 1 item 17).

Runs on the CUDA card; ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse

from repro_torch.config import apply_overrides, not_ported, parse_overrides
from repro_torch.configs import get_config
from repro_torch.data import MarkovLM
from repro_torch.training.trainer import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--mesh", default=None,
                    help="data,model: sharded training (not ported)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    apply_overrides(cfg, parse_overrides(args.overrides))
    if args.mesh:
        raise not_ported(f"--mesh {args.mesh} (sharded training)", 17)

    data = MarkovLM(cfg.model.vocab_size, seed=cfg.train.seed)
    out = train(cfg, data, device=args.device)
    final = out["history"][-1] if out["history"] else {}
    if final:
        print(f"done: step={final['step']} loss={final['loss']:.4f}",
              flush=True)
    else:
        print("done: no step left to run", flush=True)
    return out


if __name__ == "__main__":
    main()
