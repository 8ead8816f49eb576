"""``arch`` resolution for the port.

Only ``opt-proxy`` is ported so far. The JAX package's other architectures
(enc-dec whisper, routed MoE, MLA, SSM and RG-LRU hybrids, the other dense
models) wait in ROADMAP.md's port queue and raise here.
"""
from __future__ import annotations

from repro_torch.config import Config
from repro_torch.configs import opt_proxy

ARCH_IDS = ["opt-proxy"]


def get_config(arch: str, smoke: bool = False) -> Config:
    if arch not in ARCH_IDS:
        raise KeyError(
            f"arch {arch!r} is not ported to repro_torch yet (ported: "
            f"{ARCH_IDS}); see ROADMAP.md, queue 1 'Modules to port'")
    cfg = opt_proxy.smoke() if smoke else opt_proxy.full()
    cfg.model.__post_init__()
    return cfg
