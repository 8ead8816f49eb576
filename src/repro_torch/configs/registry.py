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
"""
from __future__ import annotations

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
