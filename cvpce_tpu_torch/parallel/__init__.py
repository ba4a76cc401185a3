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
