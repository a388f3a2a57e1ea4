"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2 recurrent : 1 attn.

[arXiv:2402.19427] Griffin: Mixing Gated Linear Recurrences with Local
Attention.  38 layers, d_model 4096, 16 heads (MQA kv=1), d_ff 12288,
vocab 256000, head_dim 256 (from the 2b/9b family: wide MQA heads), local
attention window 2048, pattern (rec, rec, attn).

O(1) recurrent state + bounded local-attention cache => runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    mlp="geglu",
    norm="rmsnorm",
    sliding_window=2048,
    layer_pattern=("rec", "rec", "attn"),
    citation="arXiv:2402.19427",
    notes="RG-LRU gated linear recurrence (associative scan) : local MQA attn 2:1; kv=1 => head_dim sharded over model axis",
)
