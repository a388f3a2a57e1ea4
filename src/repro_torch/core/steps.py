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

``numerics`` (a ``NumericsPolicy`` that is not the training default)
engages mixed precision as the reference's step does: params and float
batch leaves are cast to the compute dtype at the loss boundary, and
with loss scaling the loss is multiplied by the scale inside the
differentiated function, the grads are unscaled in fp32, and the whole
update (params, optimizer state, scale growth) is SKIPPED when any
replica's grads are non-finite.  That decision needs every replica's
grads, so under loss scaling the R replicas' grads are held, in the
params' dtype, until one finite flag ANDed over all of them is known;
then each replica's update is written chunk by chunk, each chunk
selected against its old value with ``torch.where`` on the flag, which
stays on the device (the step reads nothing back).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core.param_avg import ExchangeConfig, as_exchanger, \
    chunks, replicate
from repro_torch.numerics import (NumericsPolicy, cast_floats,
                                  init_loss_scale_state,
                                  next_loss_scale_state)
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    """``params`` and ``opt_state`` are trees of stacked (R, ...) tensors;
    ``step`` counts the updates taken.  ``numerics`` is the loss-scale
    state (``numerics.init_loss_scale_state``: the scale, the clean-step
    counter and the skipped-step count, 0-d device tensors), None unless
    the policy scales the loss."""
    params: Any
    opt_state: Any
    step: int = 0
    numerics: Any = None


def init_param_avg_state(generator, init_fn: Callable, optimizer: Optimizer,
                         n_replicas: int, *,
                         numerics: Optional[NumericsPolicy] = None
                         ) -> TrainState:
    """``init_fn(generator)`` -> one replica's params tree; every replica
    starts from the same copy (the paper initializes both GPUs' models
    identically).  The optimizer state is initialized on one replica and
    replicated, as the reference's vmapped init, so bookkeeping scalars
    (AdamW's count) carry the replica axis too.  ``numerics`` gives the
    loss-scale state, on the params' device."""
    params = init_fn(generator)
    opt_state = replicate(optimizer.init(params), n_replicas)
    dev = tree_leaves(params)[0].device
    return TrainState(replicate(params, n_replicas), opt_state, 0,
                      init_loss_scale_state(numerics, dev))


def _per_replica_grads(loss_fn: Callable, params, batch, compute_dtype=None,
                       scale=None):
    """(r, loss, grads as a list of leaves) for each replica in turn.
    ``compute_dtype`` casts the float params and batch leaves at the loss
    boundary; ``scale`` multiplies the loss inside the differentiated
    function (the grads and the loss come out scaled)."""
    n_rep = tree_leaves(params)[0].shape[0]
    for r in range(n_rep):
        p = tree_map(lambda x: x[r].detach().requires_grad_(), params)
        b = tree_map(lambda x: x[r], batch)
        with torch.enable_grad():
            if compute_dtype is None:
                loss = loss_fn(p, b)
            else:
                loss = loss_fn(cast_floats(p, compute_dtype),
                               cast_floats(b, compute_dtype))
            if scale is not None:
                loss = loss * scale.to(loss.dtype)
            grads = list(torch.autograd.grad(loss, tree_leaves(p)))
        yield r, loss.detach(), grads


def _is_shaped_like(tree, params) -> bool:
    """``tree`` has the params' structure (a params-shaped optimizer
    subtree: SGD's velocity, AdamW's moments, the fp32 masters)."""
    if isinstance(params, dict):
        return isinstance(tree, dict) and list(tree) == list(params) and \
            all(_is_shaped_like(tree[k], params[k]) for k in params)
    if isinstance(params, (list, tuple)):
        return isinstance(tree, (list, tuple)) and \
            len(tree) == len(params) and \
            all(_is_shaped_like(a, b) for a, b in zip(tree, params))
    return torch.is_tensor(tree) and tree.shape == params.shape


def _replica_state(opt_state, params, i: int, r: int):
    """Replica ``r``'s optimizer state for the params' ``i``-th leaf: each
    params-shaped subtree replaced by its ``i``-th leaf's (1, ...) view,
    each other tensor (AdamW's count) by its 0-d view."""
    if _is_shaped_like(opt_state, params):
        return tree_leaves(opt_state)[i][r][None]
    if isinstance(opt_state, dict):
        return {k: _replica_state(v, params, i, r)
                for k, v in opt_state.items()}
    if isinstance(opt_state, (list, tuple)):
        return type(opt_state)(_replica_state(v, params, i, r)
                               for v in opt_state)
    return opt_state[r]


def _write(dst, new, finite) -> None:
    """``dst`` <- ``new``, or, with a finite flag, ``new`` where it is
    set and ``dst`` as it was where it is not (the loss-scaling skip)."""
    if finite is None:
        dst.copy_(new)
    else:
        dst.copy_(torch.where(finite, new.to(dst.dtype), dst))


def update_replica_(optimizer: Optimizer, grads, params, opt_state, r: int,
                    lr, *, finite=None, inv_scale=None) -> None:
    """Replica ``r``'s optimizer update written into its slices of
    ``params`` and ``opt_state`` (whose params-shaped subtrees, nested or
    not, are updated leaf by leaf and chunk by chunk; a 0-d entry,
    AdamW's count, once at the end).  ``grads`` is a list of replica r's
    leaves, emptied as they are used.  ``inv_scale`` unscales each grad
    chunk in fp32 first; ``finite`` (a 0-d bool tensor) keeps every old
    value where it is not set."""
    def write(dst, val, scalars: bool):
        if (dst.dim() == 0) == scalars:
            _write(dst, val, finite)

    state = new = None
    for i, p in enumerate(tree_leaves(params)):
        g = grads[i]
        grads[i] = None
        views = _replica_state(opt_state, params, i, r)
        for j, (gc, pc) in enumerate(zip(chunks(g[None], read_only=True),
                                         chunks(p[r][None]))):
            if inv_scale is not None:
                gc = gc.float() * inv_scale
            state = tree_map(lambda t: chunks(t)[j] if t.dim() else t, views)
            upd, new = optimizer.update(gc, state, pc, lr)
            _write(pc, apply_updates(pc, upd), finite)
            tree_map(lambda d, v: write(d, v, False), state, new)
    if new is not None:
        tree_map(lambda d, v: write(d, v, True), state, new)


def _grads_finite(grads, inv_scale) -> torch.Tensor:
    """0-d bool tensor: every unscaled grad leaf's fp32 sum is finite
    (``numerics.all_finite`` over ``g.float() * inv_scale``, taken chunk
    by chunk so no fp32 copy of a whole leaf is made)."""
    flags = []
    for g in grads:
        total = sum((c.float() * inv_scale).sum()
                    for c in chunks(g[None], read_only=True))
        flags.append(torch.isfinite(total))
    return torch.stack(flags).all()


def make_param_avg_step(loss_fn: Callable, optimizer: Optimizer,
                        schedule: Callable, *, strategy="all_reduce",
                        sync_every: int = 1,
                        numerics: Optional[NumericsPolicy] = None):
    """``loss_fn(params, batch)`` -> scalar; returns ``step(state, batch)
    -> (state, mean loss)``, which updates ``state``'s tensors in place
    and returns them (see the module's docstring).  ``strategy`` is a
    name, an ``Exchanger`` or an ``ExchangeConfig`` (which then supplies
    ``sync_every``).  ``numerics`` engages the policy's compute-dtype
    cast and loss scaling (pair it with ``optimizers.for_numerics`` for
    the fp32 masters); the default or fp32 policy leaves the step
    bit-equal to one built without it."""
    if isinstance(strategy, ExchangeConfig):
        sync_every = strategy.sync_every
    exchanger = as_exchanger(strategy)
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    active = numerics is not None and not numerics.is_training_default
    scaling = active and numerics.loss_scale != "none"
    cdt = (numerics.compute_dtype or numerics.param_dtype) if active \
        else None

    def step(state: TrainState, batch):
        lr = schedule(state.step)
        scale = state.numerics["scale"] if scaling else None
        inv = None if scale is None else 1.0 / scale
        losses, held = [], []
        for r, loss, grads in _per_replica_grads(loss_fn, state.params,
                                                 batch, cdt, scale):
            losses.append(loss if inv is None else loss * inv)
            if scaling:
                held.append(grads)     # the skip needs every replica's
                continue
            with torch.no_grad():
                update_replica_(optimizer, grads, state.params,
                                state.opt_state, r, lr)
        ns = state.numerics
        if scaling:
            with torch.no_grad():
                # ONE flag over every replica's grads: the replicas skip
                # together or not at all
                finite = torch.stack([_grads_finite(g, inv)
                                      for g in held]).all()
                for r, grads in enumerate(held):
                    update_replica_(optimizer, grads, state.params,
                                    state.opt_state, r, lr, finite=finite,
                                    inv_scale=inv)
                ns = next_loss_scale_state(numerics, ns, finite)
        # exchange & average params AND optimizer state (paper fn. 3)
        if sync_every == 1 or (state.step + 1) % sync_every == 0:
            with torch.no_grad():
                exchanger.average_((state.params, state.opt_state))
        return (TrainState(state.params, state.opt_state, state.step + 1,
                           ns),
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
