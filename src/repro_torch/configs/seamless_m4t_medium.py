"""seamless-m4t-medium [audio] — encoder-decoder multimodal backbone.

[arXiv:2308.11596] SeamlessM4T: Massively Multilingual & Multimodal Machine
Translation.  Backbone only (per assignment carve-out): 12 encoder + 12
decoder layers, d_model 1024, 16 heads (kv=16), d_ff 4096, vocab 256206.

The audio frontend (mel-spectrogram + conv feature extractor) is a STUB:
``input_specs()`` supplies precomputed frame embeddings (B, T_enc, d_model)
with T_enc = seq_len // 4 (the conformer codec's downsampling factor).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,            # decoder depth
    n_enc_layers=12,        # encoder depth
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    mlp="gelu",
    norm="layernorm",
    citation="arXiv:2308.11596",
    notes="enc-dec; audio frontend stubbed as precomputed frame embeddings; decode uses fixed 1024-frame encoder memory",
)
