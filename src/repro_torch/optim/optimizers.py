"""Optimizers as pure functions over trees of tensors (the counterpart of
``repro/optim/optimizers.py``).

The paper trains AlexNet with SGD + momentum and averages both the
parameters and the momentum across replicas (footnote 3), so optimizer
state is a tree the exchange averages like the parameters.  An optimizer
is a pair of functions bundled in ``Optimizer``:

    init(params)                        -> state
    update(grads, state, params, lr)    -> (updates, state)

and ``apply_updates`` adds the updates to the params.  A tree is nested
dicts and lists of tensors (``repro_torch.tree``); the functions work on
any leading shape, so
the trainer applies them to stacked (R, ...) replica tensors at once.
``adamw`` and ``with_master_weights`` come with the LM and numerics
slices (ROADMAP queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.tree import tree_map

OptState = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[..., tuple]
    name: str = "optimizer"


def sgd_momentum(momentum: float = 0.9, weight_decay: float = 5e-4,
                 nesterov: bool = False) -> Optimizer:
    """The paper's optimizer (AlexNet defaults: m=0.9, wd=5e-4), in the
    weight-decay form ``v = m*v + (g + wd*p)``, ``p += -lr*v``."""

    def init(params):
        return {"velocity": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, lr):
        g_eff = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        vel = tree_map(lambda v, g: momentum * v + g, state["velocity"],
                       g_eff)
        step_dir = (tree_map(lambda v, g: momentum * v + g, vel, g_eff)
                    if nesterov else vel)
        updates = tree_map(lambda s: -lr * s, step_dir)
        return updates, {"velocity": vel}

    return Optimizer(init, update, "sgd_momentum")


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "sgd_momentum":
        return sgd_momentum(**kw)
    if name == "adamw":
        raise NotImplementedError("adamw comes with the LM training slice "
                                  "(ROADMAP queue A item 7)")
    raise ValueError(f"unknown optimizer {name!r}")
