from blocksparse_tpu_torch.models.sparse_transformer import (
    SparseTransformerLM, TransformerConfig, generate, generate_cached,
    generate_cached_scan, causal_subblock_mask, fixed_layout, strided_layout,
    dense_causal_layout,
)
from blocksparse_tpu_torch.models.sparse_lstm import (
    SparseLSTM, LSTMConfig, make_mask)

__all__ = ["SparseTransformerLM", "TransformerConfig", "generate",
           "generate_cached", "generate_cached_scan", "causal_subblock_mask",
           "fixed_layout", "strided_layout", "dense_causal_layout",
           "SparseLSTM", "LSTMConfig", "make_mask"]
