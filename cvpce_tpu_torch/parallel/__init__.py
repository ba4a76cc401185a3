from .mesh import (  # noqa: F401
    data_parallel_mesh,
    host_local,
    host_local_tree,
    make_dp_train_step,
    put_replicated,
    put_sharded,
    replicate,
    shard_batch,
)
from .spatial import (  # noqa: F401
    make_spatial_forward,
    make_spatial_infer,
    spatial_mesh,
)
