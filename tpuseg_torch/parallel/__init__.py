"""Data-parallel training across ranks, serving over a device mesh and
H-sharded forwards (counterpart of ``tpuseg.parallel``; ``--device``
takes the place of ``tpuseg``'s ``configure_backend_from_env``)."""
from tpuseg_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Ranks,
    data_parallel_size,
    initialize_distributed,
    make_mesh,
    put_global_batch,
    replicate,
    setup_data_parallel,
    shard_batch,
    shard_train_step,
    spatial_forward,
)
