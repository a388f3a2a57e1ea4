"""Architecture registry of the port (the counterpart of
``repro.configs``).

``get_config(name)`` returns the exact published ``ModelConfig``;
``--arch <id>`` resolves through ``ARCHS``.  The paper's AlexNet has its
own config class.  Of the LM families only ``dense`` runs in the port so
far (``models.transformer``); the others are here as data and raise
where a model would be built (ROADMAP queue A item 8).
"""
from __future__ import annotations

from repro_torch.configs import (alexnet, gemma_7b, llama4_maverick,
                                 minicpm_2b, minitron_8b, mixtral_8x7b,
                                 olmo_1b, phi3_vision, recurrentgemma_9b,
                                 rwkv6_7b, seamless_m4t_medium)
from repro_torch.configs.alexnet import AlexNetConfig, ConvSpec
from repro_torch.configs.base import (SHAPES, ModelConfig, MoEConfig,
                                      ShapeConfig, reduced, supports_shape)

ARCHS = {
    "gemma-7b": gemma_7b.CONFIG,
    "gemma-7b-swa": gemma_7b.SWA_VARIANT,
    "minicpm-2b": minicpm_2b.CONFIG,
    "minitron-8b": minitron_8b.CONFIG,
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
    "llama4-maverick-400b-a17b": llama4_maverick.CONFIG,
    "olmo-1b": olmo_1b.CONFIG,
    "seamless-m4t-medium": seamless_m4t_medium.CONFIG,
    "rwkv6-7b": rwkv6_7b.CONFIG,
    "phi-3-vision-4.2b": phi3_vision.CONFIG,
    "recurrentgemma-9b": recurrentgemma_9b.CONFIG,
}

# The 10 assigned architecture ids (gemma-7b-swa is a variant).
ASSIGNED = [
    "gemma-7b", "minicpm-2b", "minitron-8b", "mixtral-8x7b",
    "llama4-maverick-400b-a17b", "olmo-1b", "seamless-m4t-medium",
    "rwkv6-7b", "phi-3-vision-4.2b", "recurrentgemma-9b",
]

ALEXNET = alexnet.CONFIG
ALEXNET_SMOKE = alexnet.SMOKE
ALEXNET_FAITHFUL = alexnet.FAITHFUL
ALEXNET_FAITHFUL_SMOKE = alexnet.FAITHFUL_SMOKE


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ASSIGNED", "ALEXNET", "ALEXNET_SMOKE",
           "ALEXNET_FAITHFUL", "ALEXNET_FAITHFUL_SMOKE", "SHAPES",
           "AlexNetConfig", "ConvSpec", "ModelConfig", "MoEConfig",
           "ShapeConfig", "get_config", "reduced", "supports_shape"]
