from blocksparse_tpu_torch.ops.matmul import (
    BlocksparseMatMul, SparseProj, block_reduced_full_dw, group_param_grads,
    group_dg_grads, get_bsmm_dx_ops, largest_block, coarsen_layout,
    dw_matmul_large_n)
from blocksparse_tpu_torch.ops.lstm import (
    fused_lstm_gates, split4, concat4, sparse_relu, FusedBasicLSTMCell,
    grouped_lstm, grouped_lstm_init, group_lstm_grads)
from blocksparse_tpu_torch.ops.conv import (
    BlocksparseConv, BlocksparseDeconv, ConvEdgeBias, conv_edge_bias_init,
    deconv_edge_bias_init, cwise_linear)
from blocksparse_tpu_torch.ops.moe import BlocksparseMoE, route_topk
from blocksparse_tpu_torch.ops.transformer import (
    BlocksparseTransformer, softmax, masked_softmax, masked_top_k_softmax,
    softmax_cross_entropy, transpose_2d, transpose_0213, top_k,
    rectified_top_k, clear_bst_constants)
from blocksparse_tpu_torch.ops.norms import (layer_norm, batch_norm,
                                             batch_norm_inference)
from blocksparse_tpu_torch.ops.ewops import (
    add, multiply, subtract, divide, maximum, minimum, negative, reciprocal,
    square, sqrt, exp, log, sigmoid, tanh, relu, elu, gelu, swish, fast_gelu,
    filter_tensor, filter_tensor_op, scale_tensor, float_cast, dropout,
    concrete_gate, concrete_gate_infer, add_n8, add_n, bias_relu,
    fancy_gather, reduce_max, assign_add, replace_add_n, restore_add_n)
from blocksparse_tpu_torch.ops.embed import embedding_lookup
from blocksparse_tpu_torch.ops.grads import gradients, recomputable
from blocksparse_tpu_torch.ops.optimize import (
    Ema, AdamOptimizer, AdafactorOptimizer, FusedAdam, FusedAdafactor,
    blocksparse_l2_decay, blocksparse_norm, blocksparse_prune,
    clip_by_global_norm, global_norm, adafactor2d_op, adafactor1d_op,
    adam_op, adam_apply, lazy_emb_adam_op, lazy_emb_adam_apply,
    blocksparse_adam_op, ema_op, mhalf_pack, mhalf_unpack, vhalf_pack,
    vhalf_unpack)
# ``quantize`` (the function) is exported by the package root: here it
# would hide the ``ops.quantize`` module
from blocksparse_tpu_torch.ops.quantize import (
    QuantizeSpec, QuantizeTracker, quantize_emax_estimate, log_stats)

__all__ = [
    "BlocksparseMatMul", "SparseProj", "block_reduced_full_dw",
    "group_param_grads", "group_dg_grads", "get_bsmm_dx_ops",
    "largest_block", "coarsen_layout", "dw_matmul_large_n",
    "fused_lstm_gates", "split4", "concat4", "sparse_relu",
    "FusedBasicLSTMCell", "grouped_lstm", "grouped_lstm_init",
    "group_lstm_grads", "BlocksparseConv", "BlocksparseDeconv",
    "ConvEdgeBias", "conv_edge_bias_init", "deconv_edge_bias_init",
    "cwise_linear", "BlocksparseMoE", "route_topk", "BlocksparseTransformer",
    "softmax", "masked_softmax", "masked_top_k_softmax",
    "softmax_cross_entropy", "transpose_2d", "transpose_0213", "top_k",
    "rectified_top_k", "clear_bst_constants", "layer_norm", "batch_norm",
    "batch_norm_inference", "add", "multiply", "subtract", "divide",
    "maximum", "minimum", "negative", "reciprocal", "square", "sqrt", "exp",
    "log", "sigmoid", "tanh", "relu", "elu", "gelu", "swish", "fast_gelu",
    "filter_tensor", "filter_tensor_op", "scale_tensor", "float_cast",
    "dropout", "concrete_gate", "concrete_gate_infer", "add_n8", "add_n",
    "bias_relu", "fancy_gather", "reduce_max", "assign_add",
    "replace_add_n", "restore_add_n", "embedding_lookup", "gradients",
    "recomputable", "Ema", "AdamOptimizer", "AdafactorOptimizer",
    "FusedAdam", "FusedAdafactor", "blocksparse_l2_decay",
    "blocksparse_norm", "blocksparse_prune", "clip_by_global_norm",
    "global_norm", "adafactor2d_op", "adafactor1d_op", "adam_op",
    "adam_apply", "lazy_emb_adam_op", "lazy_emb_adam_apply",
    "blocksparse_adam_op", "ema_op", "mhalf_pack", "mhalf_unpack",
    "vhalf_pack", "vhalf_unpack", "QuantizeSpec", "QuantizeTracker",
    "quantize_emax_estimate", "log_stats"]
