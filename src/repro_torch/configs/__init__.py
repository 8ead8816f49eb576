"""Architecture registry of the port (opt-proxy, internlm2-1.8b,
falcon-mamba-7b)."""
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: F401
