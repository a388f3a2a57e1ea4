"""The precision policy carried on model configs (the counterpart of
``repro/numerics.py``: ``NumericsPolicy`` field for field, its presets,
the tree helpers and the loss-scale state).

* **models/** read ``param_dtype(cfg)`` at init (None inherits the
  config's ``dtype``, bf16 for the LM zoo's published configs).
* **core/steps.py + optim/** read ``compute_dtype`` / ``master_weights``
  / ``loss_scale``: bf16 compute with fp32 master weights held in the
  optimizer state, and static or dynamic loss scaling whose non-finite
  check SKIPS the update on every replica and halves the scale
  (``next_loss_scale_state``).
* **serving/ + models/attention.py** read ``kv_cache_dtype``
  (``kv_cache_spec``).
* **train_loop/** stashes ``describe()`` in the checkpoint's
  ``run_meta``.

The default policy is inert: ``is_training_default`` gates every change
to the train step, so ``numerics=fp32`` is bit-equal to a step built with
no policy.  The loss-scale state's scalars are device tensors: the step
never reads them on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.tree import tree_leaves, tree_map

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


def dtype_name(dtype: torch.dtype) -> str:
    """A ``torch.dtype`` by its name (``"bfloat16"``, ...), as numpy and
    the reference's checkpoints spell it."""
    return str(dtype).replace("torch.", "")


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
        for name in ("param_dtype", "compute_dtype", "accum_dtype"):
            val = getattr(self, name)
            if val is not None and val not in DTYPES:
                # the reference's jnp.dtype raises TypeError on a bad name
                raise TypeError(f"{name}: unknown dtype {val!r}; known: "
                                f"{sorted(DTYPES)}")
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
        if self.loss_scale_init <= 0:
            raise ValueError(f"loss_scale_init must be > 0, got "
                             f"{self.loss_scale_init}")

    @property
    def is_training_default(self) -> bool:
        """True when the train-side policy is inert: the train steps
        take the pre-policy path verbatim (``kv_cache_dtype`` is serve-side
        only)."""
        return (self.compute_dtype is None and not self.master_weights
                and self.loss_scale == "none")

    def describe(self) -> str:
        """Compact string for logs and the checkpoint's run_meta."""
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


PRESETS = {
    # bit-equal to a step built with no policy
    "fp32": NumericsPolicy(),
    # the mixed-precision recipe: bf16 live params and compute, fp32
    # masters in the optimizer state, dynamic loss scaling, bf16 KV cache
    "bf16": NumericsPolicy(param_dtype="bfloat16", master_weights=True,
                           loss_scale="dynamic", kv_cache_dtype="bf16"),
}


def get_policy(name) -> NumericsPolicy:
    """Preset name -> policy (a NumericsPolicy passes through)."""
    if isinstance(name, NumericsPolicy):
        return name
    if name not in PRESETS:
        raise ValueError(f"unknown numerics preset {name!r}; known: "
                         f"{sorted(PRESETS)}")
    return PRESETS[name]


def numerics_of(cfg) -> NumericsPolicy:
    """The config's policy (the default for configs without the field)."""
    pol = getattr(cfg, "numerics", None)
    return pol if pol is not None else NumericsPolicy()


def param_dtype(cfg) -> torch.dtype:
    """Init/storage dtype of the model's params (and of its inputs)."""
    pol = numerics_of(cfg)
    return torch_dtype(pol.param_dtype or getattr(cfg, "dtype", "float32"))


def compute_dtype(cfg) -> torch.dtype:
    """Dtype activations run in (falls back to the param dtype)."""
    pol = numerics_of(cfg)
    return torch_dtype(pol.compute_dtype or pol.param_dtype
                       or getattr(cfg, "dtype", "float32"))


def kv_cache_spec(cfg, model_dtype) -> tuple:
    """(storage dtype, quantized?) of the ring KV cache: ``auto`` stores
    the model dtype, ``int8`` quantizes with fp32 scales beside it."""
    sel = numerics_of(cfg).kv_cache_dtype
    if sel == "auto":
        return torch_dtype(model_dtype), False
    return _KV_TORCH[sel], sel == "int8"


# ---------------------------------------------------------------- trees ----

def cast_floats(tree, dtype):
    """Cast floating-point leaves; integer and bool leaves pass through
    (a leaf already of ``dtype`` is returned as it is)."""
    dt = torch_dtype(dtype)
    return tree_map(lambda x: x.to(dt) if x.is_floating_point() else x,
                    tree)


def all_finite(tree) -> torch.Tensor:
    """0-d bool tensor on the leaves' device: every float leaf is fully
    finite.  Each leaf is reduced to its fp32 sum first (inf and NaN
    propagate through sums), one scalar per leaf as the reference does;
    nothing is read on the host."""
    leaves = [torch.isfinite(x.float().sum()) for x in tree_leaves(tree)
              if x.is_floating_point()]
    if not leaves:
        return torch.tensor(True)
    return torch.stack(leaves).all()


# ----------------------------------------------------------- loss scale ----

def init_loss_scale_state(policy: Optional[NumericsPolicy], device=None):
    """``TrainState.numerics``: None when scaling is off, else the scale
    (fp32), the clean-step counter and the skipped-step count (int32),
    0-d tensors on ``device``, replica-identical bookkeeping."""
    if policy is None or policy.loss_scale == "none":
        return None
    return {"scale": torch.tensor(policy.loss_scale_init,
                                  dtype=torch.float32, device=device),
            "good_steps": torch.zeros((), dtype=torch.int32, device=device),
            "skipped": torch.zeros((), dtype=torch.int32, device=device)}


def next_loss_scale_state(policy: NumericsPolicy, ns: dict, finite) -> dict:
    """Roll the loss-scale state one step.

    ``dynamic``: non-finite grads halve the scale (floor 1.0) and reset
    the clean-step counter; ``growth_interval`` consecutive clean steps
    double it (cap 2**24).  ``static``: the scale never moves.  Both
    count skipped steps; the update itself is skipped by the caller.
    ``finite`` is a 0-d bool tensor (or a bool)."""
    finite = torch.as_tensor(finite, device=ns["skipped"].device)
    skipped = ns["skipped"] + (1 - finite.to(torch.int32))
    if policy.loss_scale == "static":
        return {"scale": ns["scale"], "good_steps": ns["good_steps"],
                "skipped": skipped}
    good = torch.where(finite, ns["good_steps"] + 1,
                       torch.zeros_like(ns["good_steps"]))
    grow = good >= policy.growth_interval
    scale = torch.where(finite,
                        torch.where(grow, ns["scale"] * 2.0, ns["scale"]),
                        ns["scale"] * 0.5)
    scale = scale.clamp(1.0, 2.0 ** 24)
    good = torch.where(grow, torch.zeros_like(good), good)
    return {"scale": scale, "good_steps": good, "skipped": skipped}


def fp32_numerics(device: torch.device) -> None:
    """fp32 end to end on the card (no TF32, and bf16 GEMMs reduce in
    fp32 as the reference's ``preferred_element_type`` does; the bf16
    preset keeps these settings: its conv-grads and fp32 sums run TF32-free
    too), and
    deterministic library algorithms so a resumed run can repeat an
    uninterrupted one."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
