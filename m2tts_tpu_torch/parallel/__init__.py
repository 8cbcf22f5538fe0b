"""Multi-device execution of the port: the ('data', 'model') mesh over
``torch.distributed`` (``mesh.py``) and the tensor-parallel placement of
the transformer blocks (``partition.py``)."""

from m2tts_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    init_distributed,
    make_mesh,
    replicate_tree,
    shard_batch,
)
from m2tts_tpu_torch.parallel.partition import (  # noqa: F401
    TP_RULES,
    full_tree,
    partition_specs,
    shard_tree,
    tree_shardings,
)
