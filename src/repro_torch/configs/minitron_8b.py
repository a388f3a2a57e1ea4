"""minitron-8b [dense] — pruned Nemotron-4.

[arXiv:2407.14679] Compact Language Models via Pruning and Knowledge
Distillation.  32 layers, d_model 4096, 32 heads (GQA kv=8), d_ff 16384,
vocab 256000, head_dim 128.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    mlp="swiglu",
    norm="layernorm",
    citation="arXiv:2407.14679",
    notes="pruned nemotron; GQA 4:1",
)
