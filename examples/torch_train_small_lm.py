"""Train a small LM on the PyTorch port for a few hundred steps, with
checkpoints, restarts and straggler logging.

    PYTHONPATH=src python examples/torch_train_small_lm.py [--steps 300] \
        [--big] [--device cpu]

The twin of ``examples/train_small_lm.py``, importing ``repro_torch`` only.
``--big`` trains the full opt-proxy (12 layers, d_model 768, ~124M
parameters) at batch 16 × 128 and lr 1e-3; the default is the smoke config
(batch 8 × 32, lr 3e-3), which finishes in about a minute on the CPU.
SIGTERM checkpoints at the next step boundary, and a rerun resumes exactly
(the data stream's position included). The checkpoints are the JAX
TrainState's layout: ``launch.quantize train.ckpt_dir=<dir>`` quantizes the
trained weights, and the JAX trainer restores them. Runs on the CUDA card;
``--device cpu`` runs on the CPU.
"""
import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config
from repro_torch.data import MarkovLM
from repro_torch.training.trainer import train

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--big", action="store_true")
ap.add_argument("--ckpt", default=os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "artifacts",
    "torch_example_ckpt"))
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()

cfg = get_config("opt-proxy", smoke=not args.big)
cfg.train.steps = args.steps
cfg.train.global_batch_size = 16 if args.big else 8
cfg.train.seq_len = 128 if args.big else 32
cfg.train.lr = 1e-3 if args.big else 3e-3
cfg.train.ckpt_dir = args.ckpt
cfg.train.ckpt_every = 50
cfg.train.log_every = 10

data = MarkovLM(cfg.model.vocab_size, seed=0, branching=3)
out = train(cfg, data, device=args.device)
hist = out["history"]
if hist:
    print(f"\nfinal loss: {hist[-1]['loss']:.4f} "
          f"(first: {hist[0]['loss']:.4f})")
    print(f"straggler outliers: {out['straggler_outliers']}")
    print(f"checkpoints in {args.ckpt}: re-run to resume from step "
          f"{hist[-1]['step'] + 1}")
else:
    print(f"nothing to run: {args.ckpt} is already at step {args.steps}")
