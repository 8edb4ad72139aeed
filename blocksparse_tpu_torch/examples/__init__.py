"""Training entry points of the port (``python -m
blocksparse_tpu_torch.examples.enwik8``)."""
