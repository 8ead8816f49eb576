"""Architecture registry of the port (opt-proxy only in this slice)."""
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: F401
