"""The port's mesh and collectives against the JAX package's.

Four gloo ranks (``torch_dist_workers.parallel_cases``, spawned once for
the file) run ``make_mesh``, each collective and a data-parallel step of a
small product; the JAX package runs the same under ``shard_map`` on four
of the simulated CPU devices.  f32 throughout.  Tolerances: a sum over
ranks in another order, 1e-6 relative (1e-5 for the two-level sum); the
bfloat16 sums within three bf16 roundings of the largest sum (both cast
first and add in bf16, in other orders); the Adam step 1e-6, and 1e-5
against one device on the whole batch.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from blocksparse_tpu import parallel as jax_par
from blocksparse_tpu.ops.optimize import adam_apply as jax_adam_apply

from blocksparse_tpu_torch import parallel
from blocksparse_tpu_torch import nccl
import torch_dist_workers as workers

WORLD = 4
TOL = 1e-6


@pytest.fixture(scope="module")
def ranks():
    return workers.spawn("parallel_cases", WORLD)


@pytest.fixture(scope="module")
def inp():
    return workers.collective_inputs(WORLD)


def _mesh1():
    return Mesh(np.array(jax.devices()[:WORLD]), ("dp",))


def _smap(fn, mesh, in_specs, out_specs):
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     check_vma=False)


def _ranks(ranks, key):
    return np.stack([r[key] for r in ranks])


def test_make_mesh_shapes_and_the_dp_remainder(ranks):
    for r, out in enumerate(ranks):
        assert out["mesh"] == {"shape": (WORLD, 1, 1, 1, 1),
                               "names": ("dp", "tp", "pp", "sp", "ep"),
                               "size_dp": WORLD, "rank_dp": r}
        m2 = out["mesh2"]
        dp, tp = divmod(r, 2)                 # row-major: rank = dp*2 + tp
        assert m2["shape"] == (2, 2, 1, 1, 1) and m2["rank"] == (dp, tp)
        assert m2["batch"] == (slice(4 * dp, 4 * dp + 4),
                               slice(3 * tp, 3 * tp + 3))
        assert m2["joint"] == (slice(2 * r, 2 * r + 2),)
        assert out["refused"] == ["dp 3", "tp 3"]
    # without a process group (or a mesh) the world is one rank
    assert parallel.mpi_size() == 1


def test_allreduce_and_its_gradient_match_jax(ranks, inp):
    mesh = _mesh1()
    f = _smap(lambda x: jax_par.allreduce(x[0], axis="dp")[None], mesh,
              P("dp"), P("dp"))
    x = jnp.asarray(inp["x"])
    y, vjp = jax.vjp(f, x)
    dx, = vjp(jnp.asarray(inp["dy"]))
    np.testing.assert_allclose(_ranks(ranks, "allreduce"), np.asarray(y),
                               rtol=TOL, atol=TOL)
    # the gradient is an all-reduce of dy, as JAX's transpose of psum
    # without vma checks (and the reference's nccl.py)
    np.testing.assert_allclose(_ranks(ranks, "allreduce_grad"),
                               np.asarray(dx), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.asarray(dx)[0], inp["dy"].sum(0),
                               rtol=TOL, atol=TOL)


def test_hierarchical_allreduce_equals_the_flat_one_and_jax(ranks, inp):
    dcn = ici = 2
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(dcn, ici),
                ("dcn", "ici"))
    spec = P("dcn", "ici")

    def hier(x):
        return jax_par.hierarchical_allreduce(
            x[0, 0], fast_axis="ici", slow_axis="dcn")[None, None]
    want = np.asarray(_smap(hier, mesh, spec, spec)(
        jnp.asarray(inp["h"]).reshape(dcn, ici, 4, 4))).reshape(WORLD, 4, 4)
    for key in ("hier", "flat", "prereduce"):
        np.testing.assert_allclose(_ranks(ranks, key), want, rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(_ranks(ranks, "hier")[0], inp["h"].sum(0),
                               rtol=1e-5, atol=1e-6)
    # a leading dim of 3 does not divide by the fast axis: the flat sum
    np.testing.assert_allclose(_ranks(ranks, "hier_odd")[1],
                               inp["odd"].sum(0), rtol=1e-5, atol=1e-6)


def test_group_allreduce_casts_before_the_sum_like_jax(ranks, inp):
    mesh = _mesh1()

    def step(a, b):
        out = jax_par.group_allreduce([a[0], {"b": b[0]}],
                                      cast_all=jnp.bfloat16, axis="dp")
        return out[0][None], out[1]["b"][None]
    a, b = _smap(step, mesh, (P("dp"), P("dp")), (P("dp"), P("dp")))(
        jnp.asarray(inp["x"]), jnp.asarray(inp["h"]))
    assert all(r["group_dtype"] == "torch.bfloat16" for r in ranks)
    for i, want in enumerate((a, b)):
        want = np.asarray(want, np.float32)
        got = np.stack([r["group"][i] for r in ranks])
        # both add the bf16-cast values in bf16, in other orders: within
        # three roundings (2^-8 each) of the largest sum
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=3 * 2 ** -8 * np.abs(want).max())


def test_reduce_scatter_all_gather_round_trip_and_gradients(ranks, inp):
    mesh = _mesh1()
    x = jnp.asarray(inp["rs"])

    def rs(x):
        return jax_par.reduce_scatter(x[0], axis="dp")[None]

    def loss(x):
        return jnp.sum(_smap(rs, mesh, P("dp"), P("dp"))(x) ** 2)
    r = np.asarray(_smap(rs, mesh, P("dp"), P("dp"))(x))
    g = np.asarray(jax.grad(loss)(x))
    np.testing.assert_allclose(_ranks(ranks, "rs"), r, rtol=TOL, atol=TOL)
    total = inp["rs"].sum(0)
    for out in ranks:                          # every rank holds the sum
        np.testing.assert_allclose(out["rs_ag"], total, rtol=TOL, atol=TOL)
    # the reduce-scatter's gradient is an all-gather of 2·r
    np.testing.assert_allclose(_ranks(ranks, "rs_grad"), g, rtol=TOL,
                               atol=TOL)

    def ag(x):
        return jax_par.all_gather(x[0], axis="dp", concat_dimension=1)[None]
    xs = jnp.asarray(inp["x"])
    y, vjp = jax.vjp(_smap(ag, mesh, P("dp"), P("dp")), xs)
    dx, = vjp(2 * y)
    np.testing.assert_allclose(_ranks(ranks, "ag1"), np.asarray(y),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_ranks(ranks, "ag1_grad"), np.asarray(dx),
                               rtol=TOL, atol=TOL)


def test_sync_variables_takes_rank_zeros_values(ranks, inp):
    mesh = _mesh1()
    y = _smap(lambda p: jax_par.sync_variables_op({"p": p[0]},
                                                  axis="dp")["p"][None],
              mesh, P("dp"), P("dp"))(jnp.asarray(inp["sync"]))
    np.testing.assert_array_equal(_ranks(ranks, "sync"), np.asarray(y))
    for out in ranks:
        np.testing.assert_array_equal(out["sync"], inp["sync"][0])


def test_pass_throughs_and_the_nccl_module():
    assert parallel.serialize_allreduce_ops("ops") == "ops"
    x = torch.ones(2)
    assert parallel.identity_sync(x) is x
    assert parallel.identity_sync(x, x) == (x, x)
    assert nccl.serialize_nccl_ops is nccl.serialize_allreduce_ops
    for name in ("allreduce", "hierarchical_allreduce", "group_allreduce",
                 "sync_variables_op", "sync_globals_zero_init_op",
                 "identity_sync", "reduce_scatter", "all_gather",
                 "mpi_size", "mpi_rank"):
        assert hasattr(nccl, name), name
    # GPipe is ported: the package exports the JAX package's four names
    # (test_torch_pipeline holds them against JAX's)
    from blocksparse_tpu_torch.parallel import pipeline
    import blocksparse_tpu.parallel as jax_parallel
    for name in ("gpipe", "broadcast_from_last", "microbatch",
                 "unmicrobatch"):
        assert hasattr(jax_parallel, name), name
        assert getattr(parallel, name) is getattr(pipeline, name), name


def test_passthroughs_hold_on_every_rank(ranks):
    assert all(all(r["passthrough"]) for r in ranks)


def test_dp_training_step_matches_jax_and_one_device(ranks, inp):
    """``test_parallel.test_dp_training_step``: per-shard gradients,
    all-reduced and averaged, then one Adam step; every rank ends with the
    same weights, JAX's, and those of one device on the whole batch."""
    mesh = _mesh1()
    w = jnp.asarray(inp["w"])

    def step(w, x):
        g = jax.grad(lambda w: jnp.mean((x[0] @ w) ** 2))(w)
        g = jax_par.allreduce(g, axis="dp") / float(WORLD)
        w2, _, _ = jax_adam_apply(g, w, jnp.zeros_like(w),
                                  jnp.zeros_like(w), 0.1)
        return w2
    want = np.asarray(_smap(step, mesh, (P(None, None), P("dp")),
                            P(None, None))(w, jnp.asarray(inp["xs"])))
    for out in ranks:
        np.testing.assert_allclose(out["dp_step"], want, rtol=TOL,
                                   atol=TOL)
    g = jax.grad(lambda w: jnp.mean((jnp.asarray(inp["xs"]) @ w) ** 2))(w)
    one, _, _ = jax_adam_apply(g, w, jnp.zeros_like(w), jnp.zeros_like(w),
                               0.1)
    np.testing.assert_allclose(ranks[0]["dp_step"], np.asarray(one),
                               rtol=1e-5, atol=1e-6)
