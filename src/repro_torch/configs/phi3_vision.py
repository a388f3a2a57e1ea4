"""phi-3-vision-4.2b [vlm] — phi3-mini decoder + CLIP frontend (stubbed).

[hf:microsoft/Phi-3-vision-128k-instruct]  32 layers, d_model 3072, 32 heads
(kv=32), d_ff 8192, vocab 32064.  The vision encoder (CLIP ViT-L/14) and
projector are a STUB per the assignment carve-out: ``input_specs()`` supplies
precomputed patch embeddings (B, 1024, d_model) scattered into the token
stream at image positions given by a mask.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    mlp="swiglu",
    norm="rmsnorm",
    n_image_tokens=1024,
    citation="hf:microsoft/Phi-3-vision-128k-instruct",
    notes="phi3-mini backbone + CLIP stub; full attention => long_500k skipped",
)
