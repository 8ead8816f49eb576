"""Architecture registry of the port (``ARCH_IDS`` lists the ported
architectures)."""
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: F401
