"""Step checkpoints and integrity-checked serving artifacts
(``checkpoint``); sharding on ``torch.distributed``: the placement rules
and quantization-group sharding (``sharding``; the mesh itself comes from
``launch/mesh.py``), gradient compression (``compression``) and GPipe
(``pipeline_parallel``)."""
from repro_torch.distributed.sharding import (QuantGroupSharding,
                                              broadcast_tree, psum,
                                              quant_group_sharding)

__all__ = ["QuantGroupSharding", "broadcast_tree", "psum",
           "quant_group_sharding"]
