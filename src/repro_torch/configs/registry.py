"""``arch`` resolution for the port.

Ported so far: ``opt-proxy``, the dense decoders ``internlm2-1.8b``,
``h2o-danube-1.8b`` (sliding-window attention on a ring cache),
``minicpm-2b`` (tied embeddings), ``stablelm-1.6b`` (LayerNorm) and
``pixtral-12b`` (precomputed patch embeddings prepended to the text), the
Mamba-1 model ``falcon-mamba-7b``, the encoder-decoder
``whisper-large-v3`` and the routed mixture of experts ``olmoe-1b-7b``. The JAX package's other
architectures raise here and name their ROADMAP.md queue 1 item.
"""
from __future__ import annotations

from repro_torch.config import Config
from repro_torch.configs import (falcon_mamba_7b, h2o_danube_1_8b,
                                 internlm2_1_8b, minicpm_2b, olmoe_1b_7b,
                                 opt_proxy, pixtral_12b, stablelm_1_6b,
                                 whisper_large_v3)

_MODULES = {"opt-proxy": opt_proxy, "internlm2-1.8b": internlm2_1_8b,
            "h2o-danube-1.8b": h2o_danube_1_8b, "minicpm-2b": minicpm_2b,
            "stablelm-1.6b": stablelm_1_6b, "pixtral-12b": pixtral_12b,
            "falcon-mamba-7b": falcon_mamba_7b,
            "whisper-large-v3": whisper_large_v3,
            "olmoe-1b-7b": olmoe_1b_7b}
ARCH_IDS = list(_MODULES)
# the JAX package's architectures still to port → their ROADMAP.md item
_UNPORTED = {"deepseek-v3-671b": 16, "recurrentgemma-9b": 16}


def get_config(arch: str, smoke: bool = False) -> Config:
    if arch not in _MODULES:
        where = (f"item {_UNPORTED[arch]}" if arch in _UNPORTED
                 else "'Modules to port'")
        raise KeyError(
            f"arch {arch!r} is not ported to repro_torch yet (ported: "
            f"{ARCH_IDS}); see ROADMAP.md, queue 1 {where}")
    mod = _MODULES[arch]
    cfg = mod.smoke() if smoke else mod.full()
    cfg.model.__post_init__()
    return cfg
