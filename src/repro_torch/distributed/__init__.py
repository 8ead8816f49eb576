"""Step checkpoints and integrity-checked serving artifacts
(``checkpoint``), and quantization-group sharding on ``torch.distributed``
(``sharding``; the mesh itself comes from ``launch/mesh.py``)."""
from repro_torch.distributed.sharding import (QuantGroupSharding,
                                              broadcast_tree, psum,
                                              quant_group_sharding)

__all__ = ["QuantGroupSharding", "broadcast_tree", "psum",
           "quant_group_sharding"]
