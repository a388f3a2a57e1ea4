"""Grouped implicit-GEMM convolution (NHWC x HWIO) with fused bias + ReLU."""
