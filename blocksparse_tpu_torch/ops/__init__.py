from blocksparse_tpu_torch.ops.matmul import BlocksparseMatMul
from blocksparse_tpu_torch.ops.conv import BlocksparseConv
from blocksparse_tpu_torch.ops.transformer import (
    BlocksparseTransformer, softmax, masked_softmax, masked_top_k_softmax,
    softmax_cross_entropy, transpose_2d, transpose_0213, top_k,
    rectified_top_k, clear_bst_constants)
from blocksparse_tpu_torch.ops.norms import layer_norm
from blocksparse_tpu_torch.ops.ewops import swish, fast_gelu, float_cast
from blocksparse_tpu_torch.ops.embed import embedding_lookup
from blocksparse_tpu_torch.ops.optimize import (AdamOptimizer,
                                                clip_by_global_norm,
                                                global_norm)

__all__ = ["BlocksparseMatMul", "BlocksparseConv", "BlocksparseTransformer",
           "layer_norm", "swish", "fast_gelu", "float_cast", "embedding_lookup",
           "softmax_cross_entropy", "AdamOptimizer", "clip_by_global_norm",
           "global_norm", "softmax", "masked_softmax", "masked_top_k_softmax",
           "transpose_2d", "transpose_0213", "top_k", "rectified_top_k",
           "clear_bst_constants"]
