"""Quickstart on the PyTorch port: quantize a model with RPIQ and compare
against GPTQ.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The twin of ``examples/quickstart.py``, importing ``repro_torch`` only.
Walks the paper's two-stage procedure on a CPU-sized LM:
  stage 1  GPTQ initialization from the global calibration Hessian,
  stage 2  Gauss-Seidel residual refinement on the single retained batch,
then packs to int4 and runs both through the same forward. Runs on the
CUDA card (the hand-written kernels); ``--device cpu`` runs their plain
versions.
"""
import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.core.pipeline import pack_for_serving, quantize_model
from repro_torch.data import MarkovLM, calibration_batches
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()
dev = resolve_device(args.device)

cfg = get_config("opt-proxy", smoke=True)
mc = cfg.model

# a model + a calibration stream (the paper: 128 C4 sequences; here: the
# deterministic synthetic corpus)
gen = torch.Generator(device=dev)
gen.manual_seed(0)
params = T.init_params(mc, gen, dev)
calib = calibration_batches(MarkovLM(mc.vocab_size, seed=7), 4, 8, 32)

# --- GPTQ only (stage 1) ----------------------------------------------------
cfg_gptq = get_config("opt-proxy", smoke=True)
cfg_gptq.quant.rpiq_iters = 0
params_gptq, rep_g = quantize_model(cfg_gptq, params, calib, device=dev)

# --- RPIQ (stage 1 + stage 2, beyond-paper exact-gram mode) ------------------
cfg.quant.rpiq_use_global_hessian = False   # eq. 6 literal (stable at α≤1)
cfg.quant.rpiq_alpha = 0.3
cfg.quant.rpiq_iters = 6
params_rpiq, rep_r = quantize_model(cfg, params, calib, device=dev)
print("GPTQ:", rep_g.summary())
print("RPIQ:", rep_r.summary())

# --- compare in output space -------------------------------------------------
toks = calib[-1]["tokens"].to(dev)
lg_fp = T.forward(mc, params, toks)
for name, p in (("gptq", params_gptq), ("rpiq", params_rpiq)):
    lg = T.forward(mc, p, toks)
    rel = float(torch.linalg.norm(lg - lg_fp) / torch.linalg.norm(lg_fp))
    print(f"{name}: relative logits error vs fp32 = {rel:.4f}")

# --- pack to the int4 serving artifact ---------------------------------------
# (packing reuses the stage-1 grid carried in the param tree, so codes
# round-trip exactly; the float path rounds weights to bf16 inside dense()
# while the packed path dequantizes the exact f32 grid values — compare by
# relative norm)
packed = pack_for_serving(cfg, params_rpiq)
lg_q = T.forward(mc, packed, toks)
lg_f = T.forward(mc, params_rpiq, toks)
rel = float(torch.linalg.norm(lg_q - lg_f) / (torch.linalg.norm(lg_f)
                                             + 1e-9))
print(f"packed int4 vs refined-grid float: rel err {rel:.5f} "
      f"({'OK' if rel < 2e-2 else 'MISMATCH'})")
