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

``--mesh d,m`` trains on a (data d, model m) mesh of ranks under
``torch.distributed.run`` (``launch/mesh.init_from_env``: gloo on the CPU
and for ranks sharing a card, NCCL with a card a rank, or the caller's
process group); the mesh must cover the world. Rank 0 alone writes the checkpoints and prints
``done:``::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --arch opt-proxy --smoke --device cpu \
        --mesh 2,1 train.steps=20

Runs on the CUDA card; ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from repro_torch.config import apply_overrides, parse_overrides
from repro_torch.configs import get_config
from repro_torch.data import MarkovLM
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.training.trainer import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--mesh", default=None,
                    help="data,model (defaults to single device)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    apply_overrides(cfg, parse_overrides(args.overrides))
    mesh, started = None, False
    if args.mesh:
        d, m = (int(x) for x in args.mesh.split(","))
        dev = resolve_device(args.device)
        started = mesh_mod.init_from_env(dev)
        if not dist.is_initialized():
            raise ValueError(f"--mesh {args.mesh} runs on ranks: start it "
                             "under torch.distributed.run")
        world = mesh_mod.world_size()
        if d * m != world:
            raise ValueError(f"--mesh {args.mesh} needs {d * m} ranks; the "
                             f"world has {world}")
        mesh = mesh_mod.make_host_mesh(data=d, model=m, device=dev)

    data = MarkovLM(cfg.model.vocab_size, seed=cfg.train.seed)
    out = train(cfg, data, device=args.device, mesh=mesh)
    final = out["history"][-1] if out["history"] else {}
    if mesh_mod.rank() == 0:
        print(f"done: step={final['step']} loss={final['loss']:.4f}"
              if final else "done: no step left to run", flush=True)
    if started:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
