"""The precision policy carried on model configs (the counterpart of
``repro/numerics.py``'s ``NumericsPolicy``, field for field).

Only the default training policy is ported: params in their config
dtype (``param_dtype`` None inherits ``cfg.dtype``, bf16 for the LM zoo's
published configs), compute in the params' dtype, fp32 optimizer state
and fp32 accumulation.  bf16 compute over fp32 master weights and loss
scaling raise where a trainer would use them (ROADMAP queue A item 6).
``kv_cache_dtype`` picks the serving KV cache's storage
(``kv_cache_spec``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

LOSS_SCALES = ("none", "static", "dynamic")
KV_CACHE_DTYPES = ("auto", "fp32", "bf16", "int8")
_KV_TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """A dtype name (``"bfloat16"``, ...) as a ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(DTYPES)}")
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class NumericsPolicy:
    param_dtype: Optional[str] = None
    compute_dtype: Optional[str] = None
    accum_dtype: str = "float32"
    master_weights: bool = False
    loss_scale: str = "none"
    loss_scale_init: float = 2.0 ** 15
    growth_interval: int = 200
    kv_cache_dtype: str = "auto"

    def __post_init__(self):
        for name in ("param_dtype", "compute_dtype"):
            val = getattr(self, name)
            if val is not None:
                torch_dtype(val)
        if self.accum_dtype != "float32":
            raise ValueError("accum_dtype is a contract, not a knob: every "
                             "kernel and optimizer accumulates float32 "
                             f"(got {self.accum_dtype!r})")
        if self.loss_scale not in LOSS_SCALES:
            raise ValueError(f"loss_scale must be one of {LOSS_SCALES}, "
                             f"got {self.loss_scale!r}")
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype must be one of "
                             f"{KV_CACHE_DTYPES}, got "
                             f"{self.kv_cache_dtype!r}")

    @property
    def is_training_default(self) -> bool:
        """True when the train-side policy is inert (the only one the
        port's trainer runs)."""
        return (self.compute_dtype is None and not self.master_weights
                and self.loss_scale == "none")

    def describe(self) -> str:
        if self == NumericsPolicy():
            return "fp32"
        parts = []
        if self.param_dtype:
            parts.append(f"param={self.param_dtype}")
        if self.compute_dtype:
            parts.append(f"compute={self.compute_dtype}")
        if self.master_weights:
            parts.append("master_fp32")
        if self.loss_scale != "none":
            parts.append(f"loss_scale={self.loss_scale}")
        if self.kv_cache_dtype != "auto":
            parts.append(f"kv={self.kv_cache_dtype}")
        return ",".join(parts) or "fp32"


def numerics_of(cfg) -> NumericsPolicy:
    pol = getattr(cfg, "numerics", None)
    return pol if pol is not None else NumericsPolicy()


def param_dtype(cfg) -> torch.dtype:
    """Init/storage dtype of the model's params (and its activations).
    Raises for a policy the port does not run yet, rather than ignore
    it."""
    pol = numerics_of(cfg)
    if not pol.is_training_default:
        raise NotImplementedError(
            f"numerics {pol.describe()} is not ported yet: see ROADMAP.md "
            "queue A item 6 (bf16 compute over fp32 master weights, loss "
            "scaling)")
    return torch_dtype(pol.param_dtype or getattr(cfg, "dtype", "float32"))


def kv_cache_spec(cfg, model_dtype) -> tuple:
    """(storage dtype, quantized?) of the ring KV cache: ``auto`` stores
    the model dtype, ``int8`` quantizes with fp32 scales beside it."""
    sel = numerics_of(cfg).kv_cache_dtype
    if sel == "auto":
        return torch_dtype(model_dtype), False
    return _KV_TORCH[sel], sel == "int8"


def fp32_numerics(device: torch.device) -> None:
    """fp32 end to end on the card (no TF32, and bf16 GEMMs reduce in
    fp32 as the reference's ``preferred_element_type`` does), and
    deterministic library algorithms so a resumed run can repeat an
    uninterrupted one."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
