"""Serve a quantized model with batched requests on the PyTorch port.

    PYTHONPATH=src python examples/torch_quantize_and_serve.py \
        [--arch internlm2-1.8b] [--device cpu]

The twin of ``examples/quantize_and_serve.py``, importing ``repro_torch``
only. Quantizes the chosen architecture's smoke config with RPIQ, packs to
int4 (≈ 23% of the bf16 weight bytes incl. scales), and serves a batch of
prompts through prefill and the decode loop, which replays one captured
CUDA graph on the card. ``--device cpu`` runs the kernels' plain versions.
"""
import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.core.pipeline import pack_for_serving, quantize_model
from repro_torch.core.quant import QuantizedTensor
from repro_torch.data import MarkovLM, calibration_batches
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.engine import generate

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="internlm2-1.8b")
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--new-tokens", type=int, default=12)
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()
dev = resolve_device(args.device)

cfg = get_config(args.arch, smoke=True)
mc = cfg.model
cfg.quant.rpiq_use_global_hessian = False
cfg.quant.rpiq_alpha = 0.3

gen = torch.Generator(device=dev)
gen.manual_seed(0)
params = T.init_params(mc, gen, dev)
calib = calibration_batches(MarkovLM(mc.vocab_size, seed=7), 3, 4, 32)
params_q, report = quantize_model(cfg, params, calib, device=dev)
packed = pack_for_serving(cfg, params_q)
print(f"quantized {args.arch}: {report.summary()}")


def tree_bytes(t, as_bf16=False):
    if isinstance(t, QuantizedTensor):
        return sum(tree_bytes(x) for x in (t.packed, t.scales, t.zeros))
    if isinstance(t, dict):
        return sum(tree_bytes(v, as_bf16) for v in t.values())
    if isinstance(t, list):
        return sum(tree_bytes(v, as_bf16) for v in t)
    size = 2 if as_bf16 and t.dim() >= 2 else t.element_size()
    return t.numel() * size


print(f"weights: bf16 {tree_bytes(params, as_bf16=True)/1e6:.2f} MB → "
      f"int4+scales {tree_bytes(packed)/1e6:.2f} MB")

prompts = MarkovLM(mc.vocab_size, seed=3).batch(args.batch, 8)
res = generate(cfg, packed, prompts, device=dev,
               max_new_tokens=args.new_tokens, temperature=0.0)
tokens = res.tokens.cpu()
for i in range(args.batch):
    print(f"request {i}: prompt={list(map(int, prompts['tokens'][i]))} "
          f"-> {list(map(int, tokens[i]))}")
