"""Data, tensor, sequence, pipeline and expert parallelism on
``torch.distributed``: the mesh, the collectives (the experts' all-to-all
among them), the sequence-parallel attention and the GPipe pipeline."""
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
    all_to_all,
)
from blocksparse_tpu_torch.parallel.sequence import (
    sequence_parallel_attention,
    ring_attention,
    build_sp_schedules,
    build_ring_schedules,
    shard_tables,
)
from blocksparse_tpu_torch.parallel.pipeline import (
    gpipe,
    broadcast_from_last,
    microbatch,
    unmicrobatch,
    stage_forward,
    stage_backward,
    stage_parameters,
)
