"""The train and eval steps (the counterpart of the reference engine
of ``repro/core/steps.py``).

``make_param_avg_step`` is the paper's algorithm (Fig. 2): every replica
runs its own forward, backward and optimizer update with no gradient
communication, then the replicas exchange and average their params and
their optimizer state.  State leaves carry a leading replica axis R and
batches are (R, per_replica_batch, ...), as in the reference.

The reference vmaps the replicas (``replica_exec="vmap"``).  A
``torch.autograd.Function`` that launches a hand-written kernel cannot be
``torch.func.vmap``-ped, so the port runs the R replicas one after
another, as the reference's ``replica_exec="scan"`` does: replica r's
loss is taken on detached views ``p[r]`` of the stacked leaves and its
grads are stacked back to (R, ...).  The update then runs on the stacked
tensors at once (the optimizer's math is the same per replica).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.param_avg import ExchangeConfig, Exchanger, \
    as_exchanger, replicate
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    """``params`` and ``opt_state`` are trees of stacked (R, ...) tensors;
    ``step`` counts the updates taken."""
    params: Any
    opt_state: Any
    step: int = 0


def init_param_avg_state(generator, init_fn: Callable, optimizer: Optimizer,
                         n_replicas: int) -> TrainState:
    """``init_fn(generator)`` -> one replica's params tree; every replica
    starts from the same copy (the paper initializes both GPUs' models
    identically).  The optimizer state is initialized on one replica and
    replicated, as the reference's vmapped init, so bookkeeping scalars
    (AdamW's count) carry the replica axis too."""
    params = init_fn(generator)
    opt_state = replicate(optimizer.init(params), n_replicas)
    return TrainState(replicate(params, n_replicas), opt_state, 0)


def _synced(exchanger: Exchanger, params, opt_state, step: int,
            sync_every: int):
    """Apply the exchange, every step or every ``sync_every``-th step."""
    if sync_every == 1 or (step + 1) % sync_every == 0:
        return exchanger.average(params), exchanger.average(opt_state)
    return params, opt_state


def replica_grads(loss_fn: Callable, params, batch):
    """Per-replica loss and grads, one replica after another.  Returns
    (the mean of the replicas' losses, grads stacked like ``params``)."""
    n_rep = tree_leaves(params)[0].shape[0]
    losses, per_rep = [], []
    for r in range(n_rep):
        p = tree_map(lambda x: x[r].detach().requires_grad_(), params)
        b = tree_map(lambda x: x[r], batch)
        with torch.enable_grad():
            loss = loss_fn(p, b)
            per_rep.append(torch.autograd.grad(loss, tree_leaves(p)))
        losses.append(loss.detach())
    stacked = iter([torch.stack(gs) for gs in zip(*per_rep)])
    return torch.stack(losses).mean(), tree_map(lambda _: next(stacked),
                                                params)


def make_param_avg_step(loss_fn: Callable, optimizer: Optimizer,
                        schedule: Callable, *, strategy="all_reduce",
                        sync_every: int = 1):
    """``loss_fn(params, batch)`` -> scalar; returns ``step(state, batch)
    -> (state, mean loss)``.  ``strategy`` is a name, an ``Exchanger`` or
    an ``ExchangeConfig`` (which then supplies ``sync_every``)."""
    if isinstance(strategy, ExchangeConfig):
        sync_every = strategy.sync_every
    exchanger = as_exchanger(strategy)
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")

    def step(state: TrainState, batch):
        lr = schedule(state.step)
        loss, grads = replica_grads(loss_fn, state.params, batch)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params, lr)
            params = apply_updates(state.params, updates)
            # exchange & average params AND optimizer state (paper fn. 3)
            params, opt_state = _synced(exchanger, params, opt_state,
                                        state.step, sync_every)
        return TrainState(params, opt_state, state.step + 1), loss

    return step


def make_eval_step(metric_fn: Callable):
    """``metric_fn(params, batch)`` -> dict of scalar metrics, on the
    averaged model (the mean over the replica axis, the ensemble the
    paper reports); batches carry no replica axis."""

    def eval_step(params, batch):
        with torch.no_grad():
            return metric_fn(tree_map(lambda x: x.mean(0), params), batch)

    return eval_step


def reshape_for_replicas(batch, n_replicas: int):
    """(B, ...) host batch -> (R, B/R, ...)."""
    def f(x):
        b = x.shape[0]
        if b % n_replicas:
            raise ValueError(f"batch {b} does not split into {n_replicas} "
                             "replicas")
        return x.reshape((n_replicas, b // n_replicas) + tuple(x.shape[1:]))
    return tree_map(f, batch)
