"""Data parallelism over processes, one device each (``torch.distributed``)."""

from efficientdepthestimation_tpu_torch.parallel.mesh import (
    create_mesh,
    data_sharding,
    replicated_sharding,
    shard_batch,
    scale_batch_size,
    spatial_sharding,
    zero1_shardings,
    zero1_state_shardings,
)
from efficientdepthestimation_tpu_torch.parallel.multihost import (
    distributed_batch_iterator,
    make_global_batch,
    maybe_initialize_distributed,
    process_local_rows,
)
