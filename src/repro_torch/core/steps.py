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
loss is taken on detached views ``p[r]`` of the stacked leaves.

The step updates the state in place, the port's counterpart of the
reference's buffer donation (``jax.jit(..., donate_argnums)``): two
replicas of a multi-billion-param LM could not afford a new state beside
the old one on one card.  Each replica's grads are applied to its slices
as soon as its backward ends and then dropped, and the optimizer and the
exchange run one leaf, and one ``param_avg.chunks`` block of it, at a
time, so nothing of the size of the params is allocated beside them.
The state passed in is consumed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.param_avg import ExchangeConfig, as_exchanger, \
    chunks, replicate
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


def _per_replica_grads(loss_fn: Callable, params, batch):
    """(r, loss, grads as a list of leaves) for each replica in turn."""
    n_rep = tree_leaves(params)[0].shape[0]
    for r in range(n_rep):
        p = tree_map(lambda x: x[r].detach().requires_grad_(), params)
        b = tree_map(lambda x: x[r], batch)
        with torch.enable_grad():
            loss = loss_fn(p, b)
            grads = list(torch.autograd.grad(loss, tree_leaves(p)))
        yield r, loss.detach(), grads


def update_replica_(optimizer: Optimizer, grads, params, opt_state, r: int,
                    lr) -> None:
    """Replica ``r``'s optimizer update written into its slices of
    ``params`` and ``opt_state`` (whose params-shaped trees are updated
    leaf by leaf and chunk by chunk; a tensor entry, AdamW's count, once
    at the end).  ``grads`` is a list of replica r's leaves, emptied as
    they are used."""
    shaped = {k: tree_leaves(v) for k, v in opt_state.items()
              if not torch.is_tensor(v)}
    scalars = {k: v[r] for k, v in opt_state.items() if torch.is_tensor(v)}
    new = scalars
    for i, p in enumerate(tree_leaves(params)):
        g = grads[i]
        grads[i] = None
        parts = [chunks(g[None], read_only=True)] + [
            chunks(x[r][None])
            for x in [p] + [leaves[i] for leaves in shaped.values()]]
        for gc, pc, *sc in zip(*parts):
            state = dict(zip(shaped, sc), **scalars)
            upd, new = optimizer.update(gc, state, pc, lr)
            pc.copy_(apply_updates(pc, upd))
            for k, dst in zip(shaped, sc):
                dst.copy_(new[k])
    for k, v in scalars.items():
        v.copy_(new[k])


def make_param_avg_step(loss_fn: Callable, optimizer: Optimizer,
                        schedule: Callable, *, strategy="all_reduce",
                        sync_every: int = 1):
    """``loss_fn(params, batch)`` -> scalar; returns ``step(state, batch)
    -> (state, mean loss)``, which updates ``state``'s tensors in place
    and returns them (see the module's docstring).  ``strategy`` is a
    name, an ``Exchanger`` or an ``ExchangeConfig`` (which then supplies
    ``sync_every``)."""
    if isinstance(strategy, ExchangeConfig):
        sync_every = strategy.sync_every
    exchanger = as_exchanger(strategy)
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")

    def step(state: TrainState, batch):
        lr = schedule(state.step)
        losses = []
        for r, loss, grads in _per_replica_grads(loss_fn, state.params,
                                                 batch):
            losses.append(loss)
            with torch.no_grad():
                update_replica_(optimizer, grads, state.params,
                                state.opt_state, r, lr)
        # exchange & average params AND optimizer state (paper fn. 3)
        if sync_every == 1 or (state.step + 1) % sync_every == 0:
            with torch.no_grad():
                exchanger.average_((state.params, state.opt_state))
        return (TrainState(state.params, state.opt_state, state.step + 1),
                torch.stack(losses).mean())

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
