"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

[arXiv:2401.04088] Mixtral of Experts.  32 layers, d_model 4096, 32 heads
(GQA kv=8), expert d_ff 14336, vocab 32000, 8 experts top-2, SWA window 4096.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    mlp="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(n_experts=8, top_k=2),
    sliding_window=4096,
    citation="arXiv:2401.04088",
    notes="8 experts < model-axis 16 => 2-D (expert x tensor) sharding; native SWA enables long_500k",
)
