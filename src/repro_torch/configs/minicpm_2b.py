"""minicpm-2b [dense] — llama-like, trained with the WSD schedule.

[arXiv:2404.06395] MiniCPM: Unveiling the Potential of Small Language Models.
40 layers, d_model 2304, 36 heads (kv=36), d_ff 5760, vocab 122753.
head_dim = 2304/36 = 64.  The WSD (warmup-stable-decay) schedule the paper
introduces lives in ``repro_torch.optim.schedules.wsd``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    citation="arXiv:2404.06395",
    notes="WSD schedule; llama-like block; vocab 122753 exercises uneven GSPMD sharding",
)
