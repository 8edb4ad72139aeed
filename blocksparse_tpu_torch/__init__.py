"""blocksparse_tpu_torch: the PyTorch and CUDA port of blocksparse_tpu.

It serves and trains the flagship ``SparseTransformerLM`` on an NVIDIA
H100 through kernels written by hand for Hopper (``csrc/``): the
block-sparse matmul (fprop, bprop, updat), the fused block-sparse
attention (serving and training forward, dq, dk/dv) and the unfused
block-sparse attention products (nt, nn/tn), which the LM runs past a
head size of 128.  It also runs the
block-sparse conv ``BlocksparseConv(impl="bsmm")``, forward and backward,
through im2col, col2im and the same matmul kernels (the conv's other
lowerings, ragged blocks, ``BlocksparseDeconv``, the edge bias and
``cwise_linear`` in plain torch, as the JAX package leaves them to XLA),
the LM with Mixture-of-Experts MLPs (``BlocksparseMoE``, its experts'
products on the matmul kernels), and the sparse LSTM
``SparseLSTM`` (f32, feature-major) through the matmul kernels, with its
training entry point (``python -m
blocksparse_tpu_torch.examples.lstm_train``).  On the card the
LM's decode step (``generate_cached_scan``) and train step each run as
one CUDA graph, replayed a token or a step.  The LM also trains
sharded over data, tensor, sequence, pipeline and expert parallel ranks
on ``torch.distributed`` (``parallel``: the mesh, the collectives of the
reference's ``nccl`` module, gather and ring attention on shard-local
kernel tables, the GPipe schedule, the experts' all-to-all; NCCL on the
card, gloo on the CPU).  Each kernel has a
plain PyTorch version beside it, which is what runs on the CPU.

Around the kernels, in plain PyTorch as the JAX package leaves them to
XLA: the elementwise ops (dropout with reusable masks among them), layer
and batch norm, recompute and ``gradients``, the optimizers (Adam with
f32, bfloat16 or packed 16-bit slots, gated and quantized; Adafactor;
EMA; block pruning), the quantize ops, the layout tools (``utils``,
``sparsity``), ``checkpoint``, ``profiling`` and the enwik8 training
entry point (``python -m blocksparse_tpu_torch.examples.enwik8``).  The
JAX package ``blocksparse_tpu`` is the reference it is held against; this
package imports torch and never jax.
"""
from blocksparse_tpu_torch.utils import (
    reset_scalar_constants, get_entropy, set_entropy, entropy_size,
    scalar_constant, ceil_div, reduce_mul, z_order_2d, z_order_3d, magic32u,
    magic64u, bst_conv_layout, bst_deconv_layout)
from blocksparse_tpu_torch.ops import *  # noqa: F401,F403
from blocksparse_tpu_torch.ops import __all__ as _ops_all
from blocksparse_tpu_torch.ops.quantize import quantize
from blocksparse_tpu_torch.models import (
    SparseTransformerLM, TransformerConfig, generate, generate_cached,
    generate_cached_scan, SparseLSTM, LSTMConfig,
)
from blocksparse_tpu_torch.convert import (
    params_from_jax, params_to_jax, opt_state_from_jax, opt_state_to_jax,
    random_jax_params, jax_from_shards, conv_filter_from_jax,
    random_jax_conv_filter,
    lstm_params_from_jax, lstm_params_to_jax, random_jax_lstm_params,
)
from blocksparse_tpu_torch import (checkpoint, nccl, parallel, profiling,
                                   sparsity)

__all__ = ["reset_scalar_constants", "get_entropy", "set_entropy",
           "entropy_size", "scalar_constant", "ceil_div", "reduce_mul",
           "z_order_2d", "z_order_3d", "magic32u", "magic64u",
           "bst_conv_layout", "bst_deconv_layout", *_ops_all, "quantize",
           "SparseTransformerLM", "TransformerConfig", "generate",
           "generate_cached", "generate_cached_scan", "SparseLSTM",
           "LSTMConfig", "params_from_jax",
           "params_to_jax", "opt_state_from_jax", "opt_state_to_jax",
           "random_jax_params", "jax_from_shards", "conv_filter_from_jax",
           "random_jax_conv_filter", "lstm_params_from_jax",
           "lstm_params_to_jax", "random_jax_lstm_params", "checkpoint",
           "nccl", "parallel", "profiling", "sparsity"]
