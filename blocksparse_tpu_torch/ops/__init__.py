from blocksparse_tpu_torch.ops.matmul import BlocksparseMatMul
from blocksparse_tpu_torch.ops.conv import BlocksparseConv
from blocksparse_tpu_torch.ops.transformer import (BlocksparseTransformer,
                                                   softmax_cross_entropy)
from blocksparse_tpu_torch.ops.norms import layer_norm
from blocksparse_tpu_torch.ops.ewops import swish, fast_gelu, float_cast
from blocksparse_tpu_torch.ops.embed import embedding_lookup
from blocksparse_tpu_torch.ops.optimize import (AdamOptimizer,
                                                clip_by_global_norm,
                                                global_norm)

__all__ = ["BlocksparseMatMul", "BlocksparseConv", "BlocksparseTransformer",
           "layer_norm", "swish", "fast_gelu", "float_cast", "embedding_lookup",
           "softmax_cross_entropy", "AdamOptimizer", "clip_by_global_norm",
           "global_norm"]
