"""blocksparse_tpu_torch: the PyTorch and CUDA port of blocksparse_tpu.

It serves and trains the flagship ``SparseTransformerLM`` on an NVIDIA
H100 through kernels written by hand for Hopper (``csrc/``): the
block-sparse matmul (fprop, bprop, updat), the fused block-sparse
attention (serving and training forward, dq, dk/dv) and the unfused
block-sparse attention products (nt, nn/tn), which the LM runs past a
head size of 128.  It also runs the
block-sparse conv ``BlocksparseConv(impl="bsmm")``, forward and backward,
through im2col, col2im and the same matmul kernels.  On the card the
LM's decode step (``generate_cached_scan``) and train step each run as
one CUDA graph, replayed a token or a step.  Each kernel has a
plain PyTorch version beside it, which is what runs on the CPU.  The JAX
package ``blocksparse_tpu`` is the reference it is held against; this
package imports torch and never jax.
"""
from blocksparse_tpu_torch.ops import (
    BlocksparseMatMul, BlocksparseConv, BlocksparseTransformer, layer_norm,
    swish, fast_gelu, float_cast, embedding_lookup, softmax_cross_entropy,
    clip_by_global_norm, global_norm, AdamOptimizer, softmax, masked_softmax,
    masked_top_k_softmax, transpose_2d, transpose_0213, top_k,
    rectified_top_k, clear_bst_constants,
)
from blocksparse_tpu_torch.models import (
    SparseTransformerLM, TransformerConfig, generate, generate_cached,
    generate_cached_scan,
)
from blocksparse_tpu_torch.convert import (
    params_from_jax, params_to_jax, opt_state_from_jax, random_jax_params,
    conv_filter_from_jax, random_jax_conv_filter,
)

__all__ = ["BlocksparseMatMul", "BlocksparseConv", "BlocksparseTransformer",
           "layer_norm", "swish", "fast_gelu", "float_cast", "embedding_lookup",
           "softmax_cross_entropy", "clip_by_global_norm", "global_norm",
           "AdamOptimizer", "SparseTransformerLM", "TransformerConfig",
           "generate", "generate_cached", "generate_cached_scan",
           "params_from_jax", "params_to_jax",
           "opt_state_from_jax", "random_jax_params", "conv_filter_from_jax",
           "random_jax_conv_filter", "softmax", "masked_softmax",
           "masked_top_k_softmax", "transpose_2d", "transpose_0213", "top_k",
           "rectified_top_k", "clear_bst_constants"]
