"""Flash attention: the forward, dq and dk/dv CUDA kernels beside their
plain PyTorch versions (``ops`` dispatches, ``ref`` holds the plain
versions)."""
