"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay.

[arXiv:2404.05892] Eagle and Finch: RWKV with Matrix-Valued States and
Dynamic Recurrence.  32 layers, d_model 4096, d_ff 14336 (channel-mix),
vocab 65536, attention-free.  WKV6 heads: 64 heads of size 64 (d_model/64).

The recurrence is computed in chunked-parallel form (TPU-native adaptation of
the reference CUDA kernel) — in the JAX package, ``repro.kernels.rwkv6`` and
``repro.models.rwkv`` (not ported yet).  O(1) decode state => long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # WKV heads, head_dim 64
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    mlp="gelu",          # channel-mix uses squared-relu; flag handled in model
    norm="layernorm",
    citation="arXiv:2404.05892",
    notes="Finch (RWKV6): data-dependent decay, matrix-valued state; chunked-parallel prefill, O(1) decode",
)
