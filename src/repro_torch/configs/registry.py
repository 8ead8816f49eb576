"""``arch`` resolution for the port: every architecture of the JAX
package.

``opt-proxy``, the dense decoders ``internlm2-1.8b``, ``h2o-danube-1.8b``
(sliding-window attention on a ring cache), ``minicpm-2b`` (tied
embeddings), ``stablelm-1.6b`` (LayerNorm) and ``pixtral-12b``
(precomputed patch embeddings prepended to the text), the Mamba-1 model
``falcon-mamba-7b``, the encoder-decoder ``whisper-large-v3``, the routed
mixtures of experts ``olmoe-1b-7b`` and ``deepseek-v3-671b`` (multi-head
latent attention, an MTP head) and the RG-LRU / local-attention hybrid
``recurrentgemma-9b``. An unknown id raises ``KeyError``.

The assigned input-shape grid of the dry run (``launch/dryrun.py``), the
twin of the JAX package's ``configs/registry.py:45-79``:

  train_4k     seq 4096  x global_batch 256   → train step
  prefill_32k  seq 32768 x global_batch 32    → prefill forward
  decode_32k   cache 32768 x global_batch 128 → serve step (1 new token)
  long_500k    cache 524288 x global_batch 1  → serve step; sub-quadratic
               archs only (windowed attention, RG-LRU, Mamba)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.config import Config
from repro_torch.configs import (deepseek_v3_671b, falcon_mamba_7b,
                                 h2o_danube_1_8b, internlm2_1_8b, minicpm_2b,
                                 olmoe_1b_7b, opt_proxy, pixtral_12b,
                                 recurrentgemma_9b, stablelm_1_6b,
                                 whisper_large_v3)

_MODULES = {"opt-proxy": opt_proxy, "internlm2-1.8b": internlm2_1_8b,
            "h2o-danube-1.8b": h2o_danube_1_8b, "minicpm-2b": minicpm_2b,
            "stablelm-1.6b": stablelm_1_6b, "pixtral-12b": pixtral_12b,
            "falcon-mamba-7b": falcon_mamba_7b,
            "whisper-large-v3": whisper_large_v3,
            "olmoe-1b-7b": olmoe_1b_7b,
            "deepseek-v3-671b": deepseek_v3_671b,
            "recurrentgemma-9b": recurrentgemma_9b}
ARCH_IDS = list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> Config:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r} (known: {ARCH_IDS})")
    mod = _MODULES[arch]
    cfg = mod.smoke() if smoke else mod.full()
    cfg.model.__post_init__()
    return cfg


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_names_for(arch: str) -> List[str]:
    """The assigned shape cells of this arch (long_500k gated)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if get_config(arch).model.is_subquadratic():
        names.append("long_500k")
    return names


def input_shapes(arch: str, shape: str) -> ShapeSpec:
    return SHAPES[shape]
