"""The RG-LRU diagonal linear recurrence: the CUDA kernel
(``csrc/rglru.cu``) beside its plain PyTorch version (``ops`` dispatches,
``ref`` holds the plain version)."""
