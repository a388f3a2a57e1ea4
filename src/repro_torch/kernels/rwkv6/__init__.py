"""The RWKV6 WKV recurrence: the CUDA kernel (``csrc/wkv.cu``) beside its
plain PyTorch versions (``ops`` dispatches, ``ref`` holds the plain
versions)."""
