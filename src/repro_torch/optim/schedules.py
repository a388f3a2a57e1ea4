"""Learning-rate schedules (the counterpart of ``repro/optim/schedules.py``).

``step_decay`` is the paper's AlexNet schedule realized as fixed steps;
``plateau_decay`` is the rule as written: a host-side controller fed by
the validation loop that divides the LR by ``1/factor`` when the metric
stops improving.  ``wsd`` is MiniCPM's warmup-stable-decay.

A schedule is a plain callable ``step -> lr`` (a Python float: the port
runs eagerly, so there is nothing to compile).  The session works with
controllers: ``schedule()`` returns the callable for the current segment,
``update(metric)`` reports whether the LR just changed, and
``state_dict`` / ``load_state_dict`` round-trip through the checkpoint
manifest so a resumed session makes the same decisions.
"""
from __future__ import annotations

import dataclasses
import math


def constant(lr: float):
    return lambda step: float(lr)


def step_decay(lr: float, decay_every: int, factor: float = 0.1):
    return lambda step: lr * factor ** float(step // decay_every)


def cosine(lr: float, warmup: int, total: int, min_ratio: float = 0.1):
    def f(step):
        step = float(step)
        if step < warmup:
            return lr * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return (min_ratio * lr
                + (1 - min_ratio) * lr * 0.5 * (1 + math.cos(math.pi * prog)))
    return f


def wsd(lr: float, warmup: int, stable: int, decay: int,
        min_ratio: float = 0.01):
    """Warmup-Stable-Decay: linear warmup, flat plateau, then a decay
    linear in log space over the final ``decay`` steps."""
    def f(step):
        step = float(step)
        if step < warmup:
            return lr * step / max(warmup, 1)
        if step < warmup + stable:
            return float(lr)
        prog = min(max((step - warmup - stable) / max(decay, 1), 0.0), 1.0)
        return lr * math.exp(math.log(min_ratio) * prog)
    return f


class StaticController:
    """A fixed ``step -> lr`` schedule in the controller protocol: it
    never changes the LR and has no state to persist."""

    def __init__(self, fn):
        self._fn = fn

    def schedule(self):
        return self._fn

    def update(self, metric: float) -> bool:
        return False

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict) -> None:
        pass


@dataclasses.dataclass
class PlateauController:
    """Divide the LR by ``1/factor`` when the validation metric plateaus:
    no relative improvement of at least ``threshold`` for ``patience``
    consecutive ``update`` calls.  ``state_dict`` captures every decision
    input, so a resumed session replays identically."""

    lr: float
    factor: float = 0.1
    patience: int = 2
    threshold: float = 1e-3
    min_lr: float = 0.0
    mode: str = "min"                 # "min": lower metric is better
    # mutable decision state (persisted in the checkpoint manifest)
    best: float = None
    num_bad: int = 0
    n_drops: int = 0

    def __post_init__(self):
        if self.mode not in ("min", "max"):
            raise ValueError(f"mode must be min|max, got {self.mode!r}")
        if not 0 < self.factor < 1:
            raise ValueError(f"factor must be in (0,1), got {self.factor}")

    def schedule(self):
        cur = self.lr
        return lambda step: float(cur)

    def _improved(self, metric: float) -> bool:
        if self.best is None:
            return True
        # relative margin on |best|, so negative metrics compare right
        margin = self.threshold * abs(self.best)
        if self.mode == "min":
            return metric < self.best - margin
        return metric > self.best + margin

    def update(self, metric: float) -> bool:
        """Feed one validation metric; True iff the LR just dropped."""
        metric = float(metric)
        if self._improved(metric):
            self.best = metric
            self.num_bad = 0
            return False
        self.num_bad += 1
        if self.num_bad < self.patience or self.lr <= self.min_lr:
            return False
        self.lr = max(self.lr * self.factor, self.min_lr)
        self.num_bad = 0
        self.n_drops += 1
        return True

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad,
                "n_drops": self.n_drops}

    def load_state_dict(self, d: dict) -> None:
        self.lr = d["lr"]
        self.best = d["best"]
        self.num_bad = d["num_bad"]
        self.n_drops = d["n_drops"]


def plateau_decay(lr: float, factor: float = 0.1, patience: int = 2,
                  threshold: float = 1e-3, min_lr: float = 0.0,
                  mode: str = "min") -> PlateauController:
    """Controller realizing "divide by 10 when validation error plateaus"."""
    return PlateauController(lr, factor, patience, threshold, min_lr, mode)


def as_controller(sched):
    """Normalize a schedule or a controller to the controller API."""
    if hasattr(sched, "schedule") and hasattr(sched, "update"):
        return sched
    if callable(sched):
        return StaticController(sched)
    raise TypeError(f"not a schedule or controller: {sched!r}")
