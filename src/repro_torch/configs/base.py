"""Configuration schema for architectures and input shapes (the
counterpart of ``repro/configs/base.py``, field for field).

Every assigned architecture gets one ``configs/<id>.py`` exporting
``CONFIG`` (the exact published shape, cited) and ``reduced`` builds the
tiny same-family variants the CPU tests use.  ``kernels``, ``exchange``
and ``numerics`` take the port's own types.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.param_avg import ExchangeConfig
from repro_torch.kernels.common import KernelPolicy
from repro_torch.numerics import NumericsPolicy


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    shared_expert: bool = False
    router_aux_coef: float = 0.01
    every_k: int = 1  # MoE on every k-th layer (llama4 interleaves, k=2); dense FFN otherwise
    capacity_factor: float = 1.25  # GShard token-drop capacity; tests may raise to n_experts for no-drop
    dispatch: str = "flat"  # "flat" (global sort) | "rowwise" (per-batch-row; shard-local, perf variant)
    # perf knob (beyond-paper): GSPMD hint sharding the (E, C, d) expert
    # buffers, e.g. ("model", "data") = experts over 'model', token capacity
    # over 'data' — keeps expert contractions local (weights all-gather
    # instead of activation partial-sum all-reduce).
    buffer_sharding: tuple = None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A single transformer-family architecture.

    ``family`` selects the model implementation:
      dense   — decoder-only transformer (GQA/MQA, optional SWA)
      moe     — dense + mixture-of-experts FFN
      ssm     — RWKV6 attention-free (data-dependent decay)
      hybrid  — RG-LRU recurrent blocks : local-attention blocks (pattern)
      encdec  — encoder-decoder (audio backbone; frontend stubbed)
      vlm     — dense decoder consuming stub patch embeddings
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    mlp: str = "swiglu"          # swiglu | geglu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm | np_ln (non-parametric)
    moe: Optional[MoEConfig] = None
    sliding_window: Optional[int] = None  # None = full causal attention
    # hybrid only: repeating per-layer pattern, e.g. ("rec", "rec", "attn")
    layer_pattern: Optional[Tuple[str, ...]] = None
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    n_enc_layers: int = 0        # encdec: encoder depth (n_layers = decoder depth)
    n_image_tokens: int = 0      # vlm: stub patch-embedding count
    # perf knob (beyond-paper): pad the embedding table so the vocab dim is
    # shardable over the model axis (Megatron-style padded vocab); logits
    # are sliced back to vocab_size, so the math is unchanged.
    pad_vocab_to_multiple: int = 0
    # perf knob (beyond-paper): sequence parallelism — constrain inter-block
    # activations to shard their sequence dim over 'model', turning per-layer
    # TP all-reduces into reduce-scatter/all-gather pairs (half the bytes)
    # and sharding norm compute.
    seq_shard: bool = False
    # kernel selection (repro_torch.kernels.common.KernelPolicy): the
    # global auto|plain|cuda backend + per-op selectors; carried on the
    # config so every layer resolves the same way.  Override per run with
    # dataclasses.replace(cfg, kernels=...) — the train CLI's
    # --kernel-backend / --attn-impl flags do exactly that.
    kernels: KernelPolicy = KernelPolicy()
    # replica exchange policy (core.param_avg.ExchangeConfig): strategy
    # and sync_every (the port raises for delay=1 and compression).
    exchange: ExchangeConfig = ExchangeConfig()
    # precision policy (repro_torch.numerics.NumericsPolicy); ``dtype``
    # below is the param dtype the default policy inherits.
    numerics: NumericsPolicy = NumericsPolicy()
    dtype: str = "bfloat16"
    citation: str = ""
    notes: str = ""

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_to_multiple
        if m and self.vocab_size % m:
            return (self.vocab_size + m - 1) // m * m
        return self.vocab_size

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def supports_long_decode(self) -> bool:
        """True if a 512k-token decode has a bounded working set (sub-quadratic)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def has_decode(self) -> bool:
        return True  # all assigned archs have a decoder; AlexNet is handled separately

    def n_params(self) -> int:
        """Total parameter count (embeddings included; MoE counts all experts)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        embed = V * d * (1 if self.tie_embeddings else 2)
        gated = self.mlp in ("swiglu", "geglu")
        ffn_one = d * f * (3 if gated else 2)
        if self.moe is not None:
            moe_ffn = self.moe.n_experts * ffn_one + d * self.moe.n_experts  # + router
            if self.moe.shared_expert:
                moe_ffn += ffn_one
            frac_moe = 1.0 / self.moe.every_k
            ffn = frac_moe * moe_ffn + (1 - frac_moe) * ffn_one
        else:
            ffn = ffn_one
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.family == "ssm":
            # RWKV6 block: time-mix (~4 d^2 + low-rank ddlerp/decay) + channel-mix
            per_layer = 4 * d * d + d * f * 2 + 6 * d * 64
        elif self.family == "hybrid":
            # pattern mix: recurrent block ≈ 3*d*d (gates + in/out proj) vs attn
            pat = self.layer_pattern or ("rec", "rec", "attn")
            frac_attn = pat.count("attn") / len(pat)
            per_layer = frac_attn * attn + (1 - frac_attn) * (3 * d * d) + ffn
        else:
            per_layer = attn + ffn
        total = embed + L * per_layer
        if self.family == "encdec":
            # encoder stack + decoder cross-attention blocks
            total += self.n_enc_layers * (attn + ffn) + L * attn
        return int(total)

    def n_active_params(self) -> int:
        """Active-per-token parameter count (MoE: top_k experts only)."""
        if self.moe is None:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        gated = self.mlp in ("swiglu", "geglu")
        ffn_one = d * f * (3 if gated else 2)
        inactive = (self.moe.n_experts - self.moe.top_k) * ffn_one
        n_moe_layers = self.n_layers // self.moe.every_k
        return int(self.n_params() - n_moe_layers * inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Whether (arch, shape) is a supported dry-run combination (skips per DESIGN.md)."""
    if shape.name == "long_500k":
        return cfg.supports_long_decode()
    return True


def reduced(cfg: ModelConfig, n_layers: int = 2, d_model: int = 256,
            vocab: int = 512) -> ModelConfig:
    """A tiny same-family variant for CPU smoke tests (≤2 layers, d_model≤512)."""
    head_dim = 32
    if cfg.family == "ssm":
        # RWKV time-mix projections are d -> d: heads must tile d_model
        n_heads = d_model // head_dim
    else:
        n_heads = max(2, d_model // 64)
    n_kv = min(cfg.n_kv_heads, n_heads) if cfg.n_kv_heads > 1 else 1
    if n_heads % max(n_kv, 1):
        n_kv = n_heads
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(n_experts=min(4, cfg.moe.n_experts),
                        top_k=min(cfg.moe.top_k, 2),
                        shared_expert=cfg.moe.shared_expert)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=d_model * 2,
        vocab_size=vocab,
        moe=moe,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_image_tokens=min(cfg.n_image_tokens, 8),
        dtype="float32",
    )
