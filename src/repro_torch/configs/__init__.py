"""Architecture registry of the port (opt-proxy and internlm2-1.8b)."""
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: F401
