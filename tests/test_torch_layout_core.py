"""The port's layout core (``utils``, ``sparsity``) and the surface of the
modules ported with it against the JAX package's.

Everything here is integer or NumPy host code on both sides: held bit for
bit (layouts, mask callbacks' blocks, magic numbers, statistics).  The
signatures take the JAX ones' parameters by name, in order, with the
same defaults; a JAX ``key`` (or ``b_key``) is a ``generator`` (or
``b_generator``) here.
"""
import inspect

import numpy as np
import pytest
import torch

import blocksparse_tpu as jax_bs
from blocksparse_tpu import checkpoint as jax_ck
from blocksparse_tpu import profiling as jax_prof
from blocksparse_tpu import sparsity as jax_sp
from blocksparse_tpu import utils as jax_utils
from blocksparse_tpu.ops import ewops as jax_ew
from blocksparse_tpu.ops import optimize as jax_opt
from blocksparse_tpu.ops import quantize as jax_q

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch import utils as port_utils
import blocksparse_tpu_torch.ops.quantize as port_q


@pytest.mark.parametrize("n", [1, 5, 17, 63])
def test_z_order_and_round_up_match_jax(n):
    for z, y, x in np.ndindex(n % 7 + 1, 5, n):
        assert bt.z_order_3d(z, y, x) == jax_utils.z_order_3d(z, y, x)
        assert bt.z_order_2d(y, x) == jax_utils.z_order_2d(y, x)
    for m in (1, 8, 128):
        assert port_utils.round_up(n, m) == jax_utils.round_up(n, m)


def test_magic_division_matches_jax_and_divides():
    for d in (3, 5, 7, 9, 25, 96, 1000):
        for nmax in (255, 65535, 1 << 20):
            m, s = bt.magic32u(nmax, d)
            assert (m, s) == jax_utils.magic32u(nmax, d)
            if d > nmax:
                continue
            for n in (0, 1, d - 1, d, nmax // 2, nmax):
                assert (n * m) >> s == n // d
        assert bt.magic64u(d) == jax_utils.magic64u(d)


def test_conv_dim_helpers_match_jax():
    for S, W, pad, std, dil in ((3, 32, 1, 1, 1), (5, 17, 2, 2, 1),
                                (3, 9, 2, 1, 2), (1, 8, 0, 2, 1)):
        for fn in ("dilation_size", "same_pad"):
            args = (S, dil)
            assert getattr(port_utils, fn)(*args) == \
                getattr(jax_utils, fn)(*args)
        assert port_utils.out_dim(S, W, pad, std, dil) == \
            jax_utils.out_dim(S, W, pad, std, dil)
        assert port_utils.backward_pad(S, pad, dil) == \
            jax_utils.backward_pad(S, pad, dil)
        Q = jax_utils.out_dim(S, W, pad, std, dil)
        for q in range(Q):
            assert port_utils.conv_slice(q, W, S, pad, std, dil) == \
                jax_utils.conv_slice(q, W, S, pad, std, dil)
        for x in range(W):
            assert port_utils.deconv_slice(x, Q, S, pad, std, dil) == \
                jax_utils.deconv_slice(x, Q, S, pad, std, dil)


CONV_CASES = [dict(h=1, w=64, r=1, s=5, stride=1, blk=16),
              dict(h=8, w=8, r=3, s=3, stride=1, blk=16),
              dict(h=8, w=8, r=3, s=3, stride=2, blk=8, auto=False),
              dict(h=4, w=16, r=2, s=2, stride=2, blk=8)]


@pytest.mark.parametrize("case", range(len(CONV_CASES)))
@pytest.mark.parametrize("kind", ["conv", "deconv"])
def test_bst_conv_layouts_match_jax(kind, case):
    c = CONV_CASES[case]
    args = (c["h"], c["w"], c["r"], c["s"], c["stride"], c["blk"],
            c.get("auto", True))
    name = f"bst_{kind}_layout"
    lay_j, cb_j = getattr(jax_utils, name)(*args)
    lay_p, cb_p = getattr(bt, name)(*args)
    assert lay_p.dtype == lay_j.dtype
    np.testing.assert_array_equal(lay_p, lay_j)
    for q, k in zip(*np.nonzero(lay_j)):
        np.testing.assert_array_equal(
            cb_p((c["blk"], c["blk"]), 0, q, k, 0),
            cb_j((c["blk"], c["blk"]), 0, q, k, 0))


def test_conv_layout_refuses_what_jax_refuses():
    with pytest.raises(AssertionError):
        jax_utils.bst_conv_layout(8, 8, 4, 4, 1, 8)
    with pytest.raises(ValueError):
        bt.bst_conv_layout(8, 8, 4, 4, 1, 8)


def test_entropy_and_scalar_constants():
    bt.set_entropy(11)
    a = torch.rand(4, generator=bt.get_entropy())
    bt.set_entropy(11)
    assert torch.equal(a, torch.rand(4, generator=bt.get_entropy()))
    assert bt.entropy_size == jax_utils.entropy_size
    c = bt.scalar_constant(2.5)
    assert c.dtype == torch.float32 and float(c) == 2.5
    t = torch.ones(2)
    assert bt.scalar_constant(t) is t
    assert bt.reset_scalar_constants() is None


@pytest.mark.parametrize("seed,density,diag", [(0, 0.25, True),
                                               (3, 0.1, True),
                                               (5, 0.5, False)])
def test_random_layout_and_stats_match_jax(seed, density, diag):
    for CB, KB in ((16, 16), (12, 40), (40, 12)):
        lay = bt.sparsity.random_layout(CB, KB, density, seed, diag)
        want = jax_sp.random_layout(CB, KB, density, seed, diag)
        assert lay.dtype == want.dtype
        np.testing.assert_array_equal(lay, want)
        assert bt.sparsity.layout_stats(lay) == jax_sp.layout_stats(want)


def test_sparsity_module_carries_the_jax_layouts():
    for name in ("fixed_layout", "strided_layout"):
        np.testing.assert_array_equal(getattr(bt.sparsity, name)(16, 4),
                                      getattr(jax_sp, name)(16, 4))
    np.testing.assert_array_equal(bt.sparsity.dense_causal_layout(8),
                                  jax_sp.dense_causal_layout(8))
    np.testing.assert_array_equal(
        bt.sparsity.causal_subblock_mask((4, 4), 0, 1, 1, 0),
        jax_sp.causal_subblock_mask((4, 4), 0, 1, 1, 0))
    np.testing.assert_array_equal(bt.sparsity.make_mask(64, "ba_5", 1),
                                  jax_sp.make_mask(64, "ba_5", 1))


RENAMED = {"key": "generator", "b_key": "b_generator"}
PAIRS = {
    "dropout": (bt.dropout, jax_ew.dropout),
    "concrete_gate": (bt.concrete_gate, jax_ew.concrete_gate),
    "filter_tensor": (bt.filter_tensor, jax_ew.filter_tensor),
    "bias_relu": (bt.bias_relu, jax_ew.bias_relu),
    "fancy_gather": (bt.fancy_gather, jax_ew.fancy_gather),
    "reduce_max": (bt.reduce_max, jax_ew.reduce_max),
    "gelu": (bt.gelu, jax_ew.gelu),
    "elu": (bt.elu, jax_ew.elu),
    "batch_norm": (bt.batch_norm, jax_bs.batch_norm),
    "batch_norm_inference": (bt.batch_norm_inference,
                             jax_bs.batch_norm_inference),
    "gradients": (bt.gradients, jax_bs.gradients),
    "AdamOptimizer.__init__": (bt.AdamOptimizer.__init__,
                               jax_opt.AdamOptimizer.__init__),
    "AdamOptimizer.apply": (bt.AdamOptimizer.apply,
                            jax_opt.AdamOptimizer.apply),
    "AdafactorOptimizer.__init__": (bt.AdafactorOptimizer.__init__,
                                    jax_opt.AdafactorOptimizer.__init__),
    "AdafactorOptimizer.apply": (bt.AdafactorOptimizer.apply,
                                 jax_opt.AdafactorOptimizer.apply),
    "Ema.__init__": (bt.Ema.__init__, jax_opt.Ema.__init__),
    "Ema.apply": (bt.Ema.apply, jax_opt.Ema.apply),
    "adafactor2d_apply": (bt.adafactor2d_op, jax_opt.adafactor2d_apply),
    "adafactor1d_apply": (bt.adafactor1d_op, jax_opt.adafactor1d_apply),
    "ema_op": (bt.ema_op, jax_opt.ema_op),
    "blocksparse_l2_decay": (bt.blocksparse_l2_decay,
                             jax_opt.blocksparse_l2_decay),
    "blocksparse_prune": (bt.blocksparse_prune, jax_opt.blocksparse_prune),
    "blocksparse_adam_op": (bt.blocksparse_adam_op,
                            jax_opt.blocksparse_adam_op),
    "lazy_emb_adam_apply": (bt.lazy_emb_adam_apply,
                            jax_opt.lazy_emb_adam_apply),
    "QuantizeSpec.__init__": (bt.QuantizeSpec.__init__,
                              jax_q.QuantizeSpec.__init__),
    "quantize": (bt.quantize, jax_q.quantize),
    "quantize_float_sim": (port_q.quantize_float_sim,
                           jax_q.quantize_float_sim),
    "log_stats": (bt.log_stats, jax_q.log_stats),
    "checkpoint.save": (bt.checkpoint.save, jax_ck.save),
    "Benchmark.__init__": (bt.profiling.Benchmark.__init__,
                           jax_prof.Benchmark.__init__),
    "bench_op": (bt.profiling.bench_op, jax_prof.bench_op),
    "bst_conv_layout": (bt.bst_conv_layout, jax_bs.bst_conv_layout),
    "bst_deconv_layout": (bt.bst_deconv_layout, jax_bs.bst_deconv_layout),
    "random_layout": (bt.sparsity.random_layout, jax_sp.random_layout),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_signature_matches_jax(name):
    """The JAX parameters in order with their defaults; the port may add
    parameters only after them (Benchmark's ``device``)."""
    port, ref = (list(inspect.signature(f).parameters.values())
                 for f in PAIRS[name])
    assert len(port) >= len(ref), name
    for p, r in zip(port, ref):
        assert p.name == RENAMED.get(r.name, r.name), (name, p.name)
        assert p.kind == r.kind, p.name
        if r.default is not inspect.Parameter.empty:
            assert p.default == r.default, p.name
