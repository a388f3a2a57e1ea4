"""olmo-1b [dense] — non-parametric LayerNorm.

[arXiv:2402.00838] OLMo: Accelerating the Science of Language Models.
16 layers, d_model 2048, 16 heads (kv=16), d_ff 8192, vocab 50304,
non-parametric LN (no scale/bias), SwiGLU... OLMo uses plain (non-gated) MLP
with d_ff 8192; we keep the published non-gated GELU MLP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    mlp="gelu",
    norm="np_ln",
    tie_embeddings=True,
    citation="arXiv:2402.00838",
    notes="non-parametric LayerNorm (elementwise_affine=False); non-gated MLP",
)
