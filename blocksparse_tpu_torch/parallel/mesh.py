"""The device mesh on ``torch.distributed``.

Counterpart of ``blocksparse_tpu/parallel/mesh.py``.  One process a
rank, as the reference's MPI + NCCL runtime had it: ``make_mesh`` lays the
world's ranks out row-major on the axes ``("dp", "tp", "pp", "sp",
"ep")`` (data, tensor, pipeline, sequence and expert parallel) as a
``torch.distributed.device_mesh.DeviceMesh``, NCCL on the card and gloo
on the CPU.  Size-1 axes are kept, so one program can name any axis
unconditionally (a collective over one is a copy).

The process group comes from the usual environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as torchrun sets them)
when none is initialised; a caller may initialise it first with a store
of its own (``torch.distributed.FileStore``), as the tests do.

Collectives over several axes at once (the LM's gradient sums) need a
group of their own: ``axis_group`` builds, at its first use for a set of
axes, one group for each of the mesh's slices along them (every rank
takes part in every ``new_group``, in the same order, as all ranks run
the same program) and keeps this rank's.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("dp", "tp", "pp", "sp", "ep")
_current = None


def make_mesh(dp=None, tp=1, pp=1, sp=1, ep=1, device="cuda",
              axis_names=AXES):
    """A DeviceMesh of shape (dp, tp, pp, sp, ep) over the world's ranks,
    rank r at the row-major position r; dp defaults to the remainder.
    ``device``: "cuda" (NCCL; each rank takes the card ``LOCAL_RANK``, or
    its rank modulo the cards) or "cpu" (gloo).  Initialises the default
    process group from the environment if there is none.  The mesh
    becomes the one the collectives use when they are given none."""
    global _current
    device = torch.device(device).type
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device == "cuda" else "gloo")
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    n = dist.get_world_size()
    if dp is None:
        if n % (tp * pp * sp * ep):
            raise ValueError(f"tp {tp} x pp {pp} x sp {sp} x ep {ep} does "
                             f"not divide the world size {n}")
        dp = n // (tp * pp * sp * ep)
    if dp * tp * pp * sp * ep != n:
        raise ValueError(f"mesh {(dp, tp, pp, sp, ep)} does not cover the "
                         f"world size {n}")
    _current = DeviceMesh(device, torch.arange(n).reshape(dp, tp, pp, sp, ep),
                          mesh_dim_names=tuple(axis_names))
    return _current


def current_mesh(mesh=None):
    """``mesh``, or the last one ``make_mesh`` built."""
    mesh = mesh if mesh is not None else _current
    if mesh is None:
        raise ValueError("no mesh: build one with make_mesh")
    return mesh


def _axes(axis):
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def mpi_size(mesh=None, axis="dp"):
    """The number of ranks along ``axis`` (a name or a tuple of names);
    with no mesh (and none built), the world size, as the reference's DP
    world size."""
    if mesh is None and _current is None:
        return dist.get_world_size() if dist.is_initialized() else 1
    mesh = current_mesh(mesh)
    size = 1
    for a in _axes(axis):
        size *= mesh.mesh.shape[mesh.mesh_dim_names.index(a)]
    return size


def mpi_rank(axis="dp", mesh=None):
    """This rank's coordinate along ``axis`` (the JAX ``axis_index``)."""
    mesh = current_mesh(mesh)
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis):
    """The process group of this rank's slice of ``mesh`` along ``axis``
    (a name or a tuple of names; a tuple's order is the mesh's)."""
    axes = _axes(axis)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = mesh.__dict__.setdefault("_bs_axis_groups", {})
    key = tuple(sorted(axes, key=mesh.mesh_dim_names.index))
    if key not in groups:
        dims = [mesh.mesh_dim_names.index(a) for a in key]
        rest = [d for d in range(mesh.mesh.dim()) if d not in dims]
        slices = mesh.mesh.permute(rest + dims).reshape(
            -1, mpi_size(mesh, key))
        me = dist.get_rank()
        for ranks in slices.tolist():
            g = dist.new_group(ranks)
            if me in ranks:
                groups[key] = g
    return groups[key]


class DataSharding:
    """Which piece of a global array a rank holds: ``spec`` names, for
    each leading dim, the mesh axis (or tuple of axes) it is split over,
    or None (whole).  ``slices(shape)`` gives this rank's slices and
    ``shard(a)`` its piece."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec

    def slices(self, shape):
        out = []
        for d, axes in enumerate(self.spec):
            if axes is None:
                out.append(slice(None))
                continue
            n, r = 1, 0
            for a in _axes(axes):
                size = mpi_size(self.mesh, a)
                n, r = n * size, r * size + mpi_rank(a, self.mesh)
            if shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                                 f"by {n} shards")
            step = shape[d] // n
            out.append(slice(r * step, (r + 1) * step))
        return tuple(out)

    def shard(self, a):
        return a[self.slices(a.shape)]


def data_sharding(mesh, *spec):
    """The counterpart of the JAX ``NamedSharding(mesh, P(*spec))``: a
    ``DataSharding`` of this rank's piece."""
    return DataSharding(current_mesh(mesh), spec)
