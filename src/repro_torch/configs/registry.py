"""``arch`` resolution for the port.

Ported so far: ``opt-proxy``, ``internlm2-1.8b`` and the Mamba-1 model
``falcon-mamba-7b``. The JAX package's other architectures (enc-dec
whisper, routed MoE, MLA, RG-LRU hybrids, the other dense models) wait in
ROADMAP.md's port queue and raise here.
"""
from __future__ import annotations

from repro_torch.config import Config
from repro_torch.configs import falcon_mamba_7b, internlm2_1_8b, opt_proxy

_MODULES = {"opt-proxy": opt_proxy, "internlm2-1.8b": internlm2_1_8b,
            "falcon-mamba-7b": falcon_mamba_7b}
ARCH_IDS = list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> Config:
    if arch not in _MODULES:
        raise KeyError(
            f"arch {arch!r} is not ported to repro_torch yet (ported: "
            f"{ARCH_IDS}); see ROADMAP.md, queue 1 'Modules to port'")
    mod = _MODULES[arch]
    cfg = mod.smoke() if smoke else mod.full()
    cfg.model.__post_init__()
    return cfg
