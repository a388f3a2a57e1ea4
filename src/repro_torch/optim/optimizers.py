"""Optimizers as pure functions over trees of tensors (the counterpart of
``repro/optim/optimizers.py``).

The paper trains AlexNet with SGD + momentum and averages both the
parameters and the momentum across replicas (footnote 3), so optimizer
state is a tree the exchange averages like the parameters.  An optimizer
is a pair of functions bundled in ``Optimizer``:

    init(params)                        -> state
    update(grads, state, params, lr)    -> (updates, state)

and ``apply_updates`` adds the updates to the params.  A tree is nested
dicts, lists and tuples of tensors (``repro_torch.tree``); the functions
work on any leading shape, so the trainer applies them to stacked
(R, ...) replica tensors at once.

As in the reference, the state and the update math are fp32 whatever
the params' dtype (bf16 for the LM zoo's published configs), and
``apply_updates`` adds in fp32 and casts back to the param's dtype.
``with_master_weights`` (``for_numerics`` under a policy with
``master_weights``) keeps fp32 master copies in the optimizer state, so
the exchange averages exact fp32 masters beside the bf16 live params.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves, tree_map

OptState = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[..., tuple]
    name: str = "optimizer"


def _zeros_like(params, dtype):
    return tree_map(lambda p: torch.zeros_like(p, dtype=dtype), params)


def sgd_momentum(momentum: float = 0.9, weight_decay: float = 5e-4,
                 nesterov: bool = False,
                 state_dtype: torch.dtype = torch.float32) -> Optimizer:
    """The paper's optimizer (AlexNet defaults: m=0.9, wd=5e-4), in the
    weight-decay form ``v = m*v + (g + wd*p)``, ``p += -lr*v``.  The
    update math is fp32; ``state_dtype`` is only the velocity's storage
    type (the reference's default, fp32)."""

    def init(params):
        return {"velocity": _zeros_like(params, state_dtype)}

    def update(grads, state, params, lr):
        g_eff = tree_map(lambda g, p: g.float() + weight_decay * p.float(),
                         grads, params)
        vel = tree_map(lambda v, g: momentum * v.float() + g,
                       state["velocity"], g_eff)
        step_dir = (tree_map(lambda v, g: momentum * v + g, vel, g_eff)
                    if nesterov else vel)
        updates = tree_map(lambda s: -lr * s, step_dir)
        return updates, {"velocity": tree_map(lambda v: v.to(state_dtype),
                                              vel)}

    return Optimizer(init, update, "sgd_momentum")


def _per_replica(c, x):
    """``c`` (the count's shape: () or the replica axis (R,)) broadcast
    against a leaf ``x`` that carries the same leading axes."""
    return c.reshape(c.shape + (1,) * (x.dim() - c.dim()))


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    """AdamW with fp32 moments and an int32 step count.  The trainer
    initializes one replica and replicates the state, so the count
    carries the replica axis (R,) as the reference's vmapped init does;
    the bias corrections broadcast per replica."""

    def init(params):
        return {"mu": _zeros_like(params, torch.float32),
                "nu": _zeros_like(params, torch.float32),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=_device_of(params))}

    def update(grads, state, params, lr):
        count = state["count"] + 1
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
        nu = tree_map(lambda n, g: b2 * n + (1 - b2) * g.float().square(),
                      state["nu"], grads)
        updates = tree_map(
            lambda m, n, p: -lr * ((m / _per_replica(c1, m))
                                   / ((n / _per_replica(c2, n)).sqrt() + eps)
                                   + weight_decay * p.float()),
            mu, nu, params)
        return updates, {"mu": mu, "nu": nu, "count": count}

    return Optimizer(init, update, "adamw")


def _device_of(tree):
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else None


def apply_updates(params, updates):
    """``p + u`` in fp32, cast back to the param's dtype."""
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)


def with_master_weights(inner: Optimizer) -> Optimizer:
    """Mixed-precision wrapper: an fp32 master copy of the params lives in
    the optimizer state (``{"master": ..., "inner": inner's state}``);
    the inner update runs against the masters, and the live (bf16)
    params become a cast of the new master each step.

    The returned updates are ``new_master - p.float()``, so that the
    ``apply_updates`` contract, ``(p.float() + u).to(p.dtype)``, lands the
    params on ``cast(new_master)`` (to 1 ulp), the reference's form.  The
    masters ride in the optimizer state, which the exchange averages with
    the params (paper footnote 3)."""

    def init(params):
        # a copy even for fp32 params (``.float()`` would alias them): the
        # step writes masters and params in place, one after the other
        return {"master": tree_map(
                    lambda p: p.detach().to(torch.float32, copy=True),
                    params),
                "inner": inner.init(params)}

    def update(grads, state, params, lr):
        master = state["master"]
        updates, inner_state = inner.update(grads, state["inner"], master,
                                            lr)
        new_master = tree_map(lambda m, u: m + u, master, updates)
        out = tree_map(lambda nm, p: nm - p.float(), new_master, params)
        return out, {"master": new_master, "inner": inner_state}

    return Optimizer(init, update, inner.name + "+master")


def for_numerics(optimizer: Optimizer, numerics) -> Optimizer:
    """Wrap per the NumericsPolicy (the optimizer as it is when masters
    are off)."""
    if numerics is None or not getattr(numerics, "master_weights", False):
        return optimizer
    return with_master_weights(optimizer)


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "sgd_momentum":
        return sgd_momentum(**kw)
    if name == "adamw":
        return adamw(**kw)
    raise ValueError(f"unknown optimizer {name!r}")
