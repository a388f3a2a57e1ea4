"""Flash-decode attention: one query token per row against the ring KV
cache or the block pool, as two CUDA kernels (``decode_ring``,
``decode_table``) beside their plain PyTorch version (``ops`` dispatches,
``ref`` holds the plain version)."""
