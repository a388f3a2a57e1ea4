"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E model card family]  48 layers, d_model
5120, 40 heads (GQA kv=8), expert d_ff 8192, vocab 202048, MoE 128e top-1,
early fusion.  Llama-4 uses iRoPE chunked local attention (chunk 8192) on most
layers, which is what lets this arch run long_500k with a bounded cache; we
model it as sliding-window 8192.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    mlp="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(n_experts=128, top_k=1, shared_expert=True, every_k=2),
    sliding_window=8192,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    notes="MoE 128e top-1 + shared expert; early fusion (image tokens in-stream); chunked local attn ~= SWA 8192",
)
