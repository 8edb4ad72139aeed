"""Data, tensor and sequence parallelism on ``torch.distributed``: the
mesh, the collectives and the sequence-parallel attention.  GPipe
(``gpipe``, ``broadcast_from_last``, ``microbatch``, ``unmicrobatch``)
is not ported yet (ROADMAP §1, item 6)."""
from blocksparse_tpu_torch.parallel.mesh import (
    make_mesh,
    mpi_size,
    mpi_rank,
    data_sharding,
)
from blocksparse_tpu_torch.parallel.collectives import (
    allreduce,
    hierarchical_allreduce,
    group_allreduce,
    reduce_scatter,
    all_gather,
    sync_variables_op,
    sync_globals_zero_init_op,
    serialize_allreduce_ops,
    identity_sync,
)
from blocksparse_tpu_torch.parallel.sequence import (
    sequence_parallel_attention,
    ring_attention,
    build_sp_schedules,
    build_ring_schedules,
    shard_tables,
)
