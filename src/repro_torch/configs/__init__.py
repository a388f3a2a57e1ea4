"""Architecture registry of the port.

Only the conv family (the paper's AlexNet) is ported so far; the LM zoo
of ``repro.configs`` comes with the LM slices (ROADMAP queue A).
"""
from __future__ import annotations

from repro_torch.configs import alexnet
from repro_torch.configs.alexnet import AlexNetConfig, ConvSpec

ALEXNET = alexnet.CONFIG
ALEXNET_SMOKE = alexnet.SMOKE
ALEXNET_FAITHFUL = alexnet.FAITHFUL
ALEXNET_FAITHFUL_SMOKE = alexnet.FAITHFUL_SMOKE

__all__ = ["ALEXNET", "ALEXNET_SMOKE", "ALEXNET_FAITHFUL",
           "ALEXNET_FAITHFUL_SMOKE", "AlexNetConfig", "ConvSpec"]
