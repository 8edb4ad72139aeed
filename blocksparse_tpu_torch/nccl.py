"""The reference's ``blocksparse.nccl`` module name: its functions on
``torch.distributed`` (``blocksparse_tpu_torch.parallel.collectives``)."""
from blocksparse_tpu_torch.parallel.collectives import (  # noqa: F401
    allreduce,
    hierarchical_allreduce,
    group_allreduce,
    sync_variables_op,
    sync_globals_zero_init_op,
    serialize_allreduce_ops,
    identity_sync,
    reduce_scatter,
    all_gather,
)
from blocksparse_tpu_torch.parallel.mesh import (  # noqa: F401
    mpi_size, mpi_rank)

serialize_nccl_ops = serialize_allreduce_ops
