"""AlexNet — the paper's own architecture (Krizhevsky et al., 2012).

5 conv layers (3 followed by max-pool), local response normalization after
conv1/conv2, 2 fully-connected layers + softmax over 1000 classes.

Two flavours, field for field the reference's (``repro.configs.alexnet``):

``CONFIG`` / ``SMOKE`` (``faithful=False``)
    Ungrouped convs, LRN applied *before* the pool.

``FAITHFUL`` / ``FAITHFUL_SMOKE`` (``faithful=True``)
    The paper's dual-GPU topology: conv2/4/5 are 2-group convolutions and
    LRN runs *after* pool1/pool2 with the Caffe constants ``size=5,
    alpha=1e-4, beta=0.75``.  FAITHFUL totals 60,965,224 params.

``exchange`` and ``numerics`` carry the port's ``ExchangeConfig`` and
``NumericsPolicy`` as the reference's config carries its own
(``param_dtype(cfg)`` is the params' dtype).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.param_avg import ExchangeConfig
from repro_torch.kernels.common import KernelPolicy
from repro_torch.numerics import NumericsPolicy


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    out_channels: int
    kernel: int
    stride: int
    padding: int
    pool: bool       # 3x3 stride-2 max pool after this conv
    lrn: bool        # local response normalization after this conv
    groups: int = 1  # grouped conv (the paper's per-GPU split); must
                     # divide both in- and out-channels


@dataclasses.dataclass(frozen=True)
class AlexNetConfig:
    name: str = "alexnet"
    family: str = "conv"
    image_size: int = 227
    in_channels: int = 3
    n_classes: int = 1000
    convs: Tuple[ConvSpec, ...] = (
        ConvSpec(96, 11, 4, 0, pool=True, lrn=True),
        ConvSpec(256, 5, 1, 2, pool=True, lrn=True),
        ConvSpec(384, 3, 1, 1, pool=False, lrn=False),
        ConvSpec(384, 3, 1, 1, pool=False, lrn=False),
        ConvSpec(256, 3, 1, 1, pool=True, lrn=False),
    )
    fc_dim: int = 4096
    dropout: float = 0.5
    # faithful=True: conv -> relu -> pool -> LRN (the Caffe reference
    # net); faithful=False normalizes before pooling
    faithful: bool = False
    # LRN constants (only read where ConvSpec.lrn is set)
    lrn_n: int = 5
    lrn_alpha: float = 1e-4
    lrn_beta: float = 0.75
    lrn_k: float = 2.0
    # which implementation each kernel op runs (kernels/common.py)
    kernels: KernelPolicy = KernelPolicy()
    # replica exchange policy (core.param_avg.ExchangeConfig)
    exchange: ExchangeConfig = ExchangeConfig()
    # precision policy (repro_torch.numerics.NumericsPolicy)
    numerics: NumericsPolicy = NumericsPolicy()
    dtype: str = "float32"
    citation: str = "Krizhevsky et al. 2012; Ding et al. ICLR 2015 (this paper)"

    def __post_init__(self):
        c_in = self.in_channels
        for i, cs in enumerate(self.convs):
            if c_in % cs.groups or cs.out_channels % cs.groups:
                raise ValueError(
                    f"{self.name}: conv{i + 1} groups={cs.groups} must "
                    f"divide in={c_in} and out={cs.out_channels} channels")
            c_in = cs.out_channels

    def feature_hw(self, image_size: int = None) -> int:
        """Spatial size after the conv stack.  Raises ValueError when
        ``image_size`` is too small for the architecture (a conv or pool
        window would not fit)."""
        size = self.image_size if image_size is None else image_size
        hw = size
        for i, cs in enumerate(self.convs):
            hw = (hw + 2 * cs.padding - cs.kernel) // cs.stride + 1
            if hw < 1:
                raise ValueError(
                    f"image size {size} invalid for {self.name}: conv{i + 1} "
                    f"(k={cs.kernel}, s={cs.stride}, p={cs.padding}) would "
                    f"see a {hw}-wide feature map")
            if cs.pool:
                hw = (hw - 3) // 2 + 1
                if hw < 1:
                    raise ValueError(
                        f"image size {size} invalid for {self.name}: the "
                        f"3x3/2 pool after conv{i + 1} would see an empty "
                        "feature map")
        return hw

    def n_params(self) -> int:
        c_in = self.in_channels
        total = 0
        for cs in self.convs:
            # a grouped conv only connects within its group: Cin/G
            total += (cs.kernel * cs.kernel * (c_in // cs.groups)
                      * cs.out_channels + cs.out_channels)
            c_in = cs.out_channels
        flat = self.feature_hw() ** 2 * c_in
        total += flat * self.fc_dim + self.fc_dim
        total += self.fc_dim * self.fc_dim + self.fc_dim
        total += self.fc_dim * self.n_classes + self.n_classes
        return total


CONFIG = AlexNetConfig()

# Reduced variant for CPU tests: 64x64 images, thin channels.
SMOKE = AlexNetConfig(
    name="alexnet-smoke",
    image_size=64,
    n_classes=10,
    convs=(
        ConvSpec(16, 7, 2, 0, pool=True, lrn=True),
        ConvSpec(32, 5, 1, 2, pool=True, lrn=True),
        ConvSpec(32, 3, 1, 1, pool=False, lrn=False),
        ConvSpec(32, 3, 1, 1, pool=False, lrn=False),
        ConvSpec(32, 3, 1, 1, pool=True, lrn=False),
    ),
    fc_dim=128,
)

# The paper-faithful dual-GPU topology (see module docstring).
FAITHFUL = AlexNetConfig(
    name="alexnet-faithful",
    faithful=True,
    convs=(
        ConvSpec(96, 11, 4, 0, pool=True, lrn=True),
        ConvSpec(256, 5, 1, 2, pool=True, lrn=True, groups=2),
        ConvSpec(384, 3, 1, 1, pool=False, lrn=False),
        ConvSpec(384, 3, 1, 1, pool=False, lrn=False, groups=2),
        ConvSpec(256, 3, 1, 1, pool=True, lrn=False, groups=2),
    ),
)

FAITHFUL_SMOKE = AlexNetConfig(
    name="alexnet-faithful-smoke",
    faithful=True,
    image_size=64,
    n_classes=10,
    convs=(
        ConvSpec(16, 7, 2, 0, pool=True, lrn=True),
        ConvSpec(32, 5, 1, 2, pool=True, lrn=True, groups=2),
        ConvSpec(32, 3, 1, 1, pool=False, lrn=False),
        ConvSpec(32, 3, 1, 1, pool=False, lrn=False, groups=2),
        ConvSpec(32, 3, 1, 1, pool=True, lrn=False, groups=2),
    ),
    fc_dim=128,
)
