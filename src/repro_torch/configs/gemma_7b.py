"""gemma-7b [dense] — GeGLU, head_dim=256, 16 heads / 16 kv heads.

[arXiv:2403.08295] Gemma: Open Models Based on Gemini Research and Technology.
Exact published shape: 28 layers, d_model 3072, 16 heads (kv=16), d_ff 24576
(GeGLU), vocab 256000, head_dim 256, RoPE.

``gemma-7b-swa`` is an explicit sliding-window VARIANT (gemma-2-style, window
4096) used only to exercise the dense-arch long_500k carve-out per DESIGN.md.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp="geglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    citation="arXiv:2403.08295",
    notes="GeGLU, head_dim=256 (decoupled from d_model/heads); MQA on the 2b sibling",
)

SWA_VARIANT = dataclasses.replace(
    CONFIG, name="gemma-7b-swa", sliding_window=4096,
    notes=CONFIG.notes + "; gemma-2-style SWA variant for long_500k",
)
