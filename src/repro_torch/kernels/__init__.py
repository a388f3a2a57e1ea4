"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version; ``common.KernelPolicy`` selects between them and ``_build``
compiles the ``*/csrc/*.cu`` sources on first use."""
