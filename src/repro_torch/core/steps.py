"""The train, eval and serve steps (the counterpart of the reference
engine of ``repro/core/steps.py``).

``make_param_avg_step`` is the paper's algorithm (Fig. 2): every replica
runs its own forward, backward and optimizer update with no gradient
communication, then the replicas exchange and average their params and
their optimizer state.  State leaves carry a leading replica axis R and
batches are (R, per_replica_batch, ...), as in the reference.
``make_mesh_param_avg_step`` is the same algorithm as a program over a
``torch.distributed`` group of R ranks, one replica each: a rank's
leaves keep a leading axis of 1 and the exchange is a real collective
(``param_avg.ReplicaGroup``).  ``make_grad_avg_step`` is the modern
baseline: one param copy, the loss a mean over the global batch.

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
The state passed in is consumed.  The one exception is ``delay=1``: its
exchange averages the *incoming* state and grafts this step's progress
onto that consensus, ``w' = avg(w) + (new - w)``, so a step that syncs
keeps one copy of the incoming params and optimizer state until the
graft (the reference keeps both as values of its program).

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
stays on the device (the step reads nothing back; the mesh engine ANDs
the ranks' flags with an ``all_reduce(MIN)``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.profiler import record_function

from repro_torch.core.param_avg import (ExchangeConfig, Exchanger,
                                        ReplicaGroup, as_exchanger, chunks,
                                        replicate)
from repro_torch.numerics import (NumericsPolicy, cast_floats,
                                  init_loss_scale_state,
                                  next_loss_scale_state)
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    """``params`` and ``opt_state`` are trees of stacked (R, ...) tensors;
    ``step`` counts the updates taken.  ``exchange`` is the delayed
    compressed exchange's state (``init_exchange_state``: the
    replica-identical consensus ``base`` the deltas are taken against and
    the per-replica error-feedback ``residual``), None for the
    synchronous path and for an uncompressed ``delay=1``.  ``numerics``
    is the loss-scale state (``numerics.init_loss_scale_state``: the
    scale, the clean-step counter and the skipped-step count, 0-d device
    tensors), None unless the policy scales the loss."""
    params: Any
    opt_state: Any
    step: int = 0
    exchange: Any = None
    numerics: Any = None


def init_exchange_state(params_r, opt_r, exchanger: Exchanger,
                        delay: int = 0):
    """The delayed compressed exchange's state (None when the exchange is
    stateless): ``base`` a copy of the initial replicated state (every
    replica starts identical, so it IS the consensus), ``residual`` fp32
    zeros (0-d for 0-d leaves: nothing dropped yet)."""
    if delay == 0 or not exchanger.is_stateful \
            or exchanger.strategy == "none":
        return None
    tree = (params_r, opt_r)
    return {"base": tree_map(torch.clone, tree),
            "residual": tree_map(lambda x: torch.zeros(
                x.shape, dtype=torch.float32, device=x.device), tree)}


def init_param_avg_state(generator, init_fn: Callable, optimizer: Optimizer,
                         n_replicas: int, *,
                         exchange: Optional[ExchangeConfig] = None,
                         numerics: Optional[NumericsPolicy] = None
                         ) -> TrainState:
    """``init_fn(generator)`` -> one replica's params tree; every replica
    starts from the same copy (the paper initializes both GPUs' models
    identically).  The optimizer state is initialized on one replica and
    replicated, as the reference's vmapped init, so bookkeeping scalars
    (AdamW's count) carry the replica axis too.  ``exchange`` gives the
    delayed compressed exchange its state, ``numerics`` the loss-scale
    state, on the params' device.  The mesh engine's rank state is this
    with ``n_replicas=1`` (every replica starts the same)."""
    params = init_fn(generator)
    opt_state = replicate(optimizer.init(params), n_replicas)
    params = replicate(params, n_replicas)
    aux = None
    if exchange is not None:
        aux = init_exchange_state(params, opt_state, exchange.exchanger(),
                                  exchange.delay)
    dev = tree_leaves(params)[0].device
    return TrainState(params, opt_state, 0, aux,
                      init_loss_scale_state(numerics, dev))


def init_grad_avg_state(generator, init_fn: Callable, optimizer: Optimizer,
                        *, numerics: Optional[NumericsPolicy] = None
                        ) -> TrainState:
    """The grad-avg baseline's state: one params copy, no replica axis."""
    params = init_fn(generator)
    dev = tree_leaves(params)[0].device
    return TrainState(params, optimizer.init(params), 0, None,
                      init_loss_scale_state(numerics, dev))


def _loss_and_grads(loss_fn: Callable, params, batch, compute_dtype=None,
                    scale=None, microbatch: int = 1):
    """(loss, grads as a list of leaves) of one replica: ``params`` its
    leaves, ``batch`` its batch.  ``compute_dtype`` casts the float params
    and batch leaves at the loss boundary; ``scale`` multiplies the loss
    inside the differentiated function (the grads and the loss come out
    scaled).

    ``microbatch`` m > 1 accumulates the grads of m slices of the batch
    in fp32 (the grads come out fp32) and returns the mean loss and
    grads, as the reference's ``_make_loss_and_grad``: slice i takes rows
    i, i + m, i + 2m, ... (its ``(b/m, m)`` split with m moved first)."""
    def one(b):
        p = tree_map(lambda x: x.detach().requires_grad_(), params)
        with torch.enable_grad():
            if compute_dtype is None:
                loss = loss_fn(p, b)
            else:
                loss = loss_fn(cast_floats(p, compute_dtype),
                               cast_floats(b, compute_dtype))
            if scale is not None:
                loss = loss * scale.to(loss.dtype)
            grads = list(torch.autograd.grad(loss, tree_leaves(p)))
        return loss.detach(), grads

    if microbatch == 1:
        return one(batch)
    lsum = None
    gsum = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            for x in tree_leaves(params)]
    for i in range(microbatch):
        loss, grads = one(tree_map(lambda x: x[i::microbatch], batch))
        # 0 + l0 is l0: the reference's fp32 sum from zero, in its order
        lsum = loss.float() if lsum is None else lsum + loss.float()
        for acc, g in zip(gsum, grads):
            acc += g.float()
    inv = 1.0 / microbatch
    return lsum * inv, [g * inv for g in gsum]


def _per_replica_grads(loss_fn: Callable, params, batch, compute_dtype=None,
                       scale=None, microbatch: int = 1):
    """(r, loss, grads as a list of leaves) for each replica in turn."""
    n_rep = tree_leaves(params)[0].shape[0]
    for r in range(n_rep):
        loss, grads = _loss_and_grads(
            loss_fn, tree_map(lambda x: x[r], params),
            tree_map(lambda x: x[r], batch), compute_dtype, scale,
            microbatch)
        yield r, loss, grads


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


def _delayed_exchange_(exchanger: Exchanger, prev, live, aux) -> None:
    """The one-step-stale exchange (delay=1), in place.  ``prev`` is the
    step's incoming (params, opt_state), copied before the update;
    ``live`` the updated state.  The exchange averages the incoming state
    (which does not depend on this step's forward and backward) and
    grafts the local progress onto that consensus::

        w_{t+1} = avg(w_t) + (new_t - w_t)

    in each leaf's dtype; 0-d leaves take the local value.  With a
    stateful (compressed) exchanger the consensus comes from
    ``Exchanger.delta`` against ``aux["base"]`` with the error-feedback
    ``aux["residual"]``, and both roll forward in place.  Dense
    exchanges go one ``chunks`` block at a time; topk selects over each
    replica's whole leaf."""
    stateful = exchanger.is_stateful
    leaves = [tree_leaves(t) for t in (prev, live)]
    if stateful:
        leaves += [tree_leaves(aux["base"]), tree_leaves(aux["residual"])]
    for w, n, *state in zip(*leaves, strict=True):
        if w.dim() == 0:
            continue
        if exchanger.compression == "topk":
            parts = [[w, n, *state]]
        else:
            parts = zip(*(chunks(t) for t in (w, n, *state)))
        for wc, nc, *sc in parts:
            if stateful:
                a, res = exchanger.delta(wc, *sc)
                sc[0].copy_(a)
                sc[1].copy_(res)
            else:
                a = exchanger.average_leaf(wc)
            nc.copy_(a + (nc - wc))


def _check_delay(exchanger: Exchanger, delay: int) -> None:
    if delay not in (0, 1):
        raise ValueError(f"delay must be 0 or 1, got {delay}")
    if exchanger.is_stateful and delay == 0 \
            and exchanger.compression == "topk":
        raise ValueError("topk compression requires delay=1 (its "
                         "base+residual state rides the delayed exchange)")


def _build_step(loss_fn: Callable, optimizer: Optimizer, schedule: Callable,
                exchanger: Exchanger, sync_every: int, microbatch: int,
                delay: int, numerics: Optional[NumericsPolicy]):
    """The step both param-avg engines run over their (R, ...) or (1, ...)
    leaves; ``exchanger.group`` makes it the mesh engine's."""
    _check_delay(exchanger, delay)
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    if microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {microbatch}")
    group = exchanger.group
    active = numerics is not None and not numerics.is_training_default
    scaling = active and numerics.loss_scale != "none"
    cdt = (numerics.compute_dtype or numerics.param_dtype) if active \
        else None

    def step(state: TrainState, batch):
        lr = schedule(state.step)
        scale = state.numerics["scale"] if scaling else None
        inv = None if scale is None else 1.0 / scale
        # every rank holds the same step counter, so the ranks skip (or
        # run) the collectives together
        sync = exchanger.strategy != "none" and (
            sync_every == 1 or (state.step + 1) % sync_every == 0)
        prev = None
        if delay == 1 and sync:
            if exchanger.is_stateful and state.exchange is None:
                raise ValueError("the compressed delay=1 exchange needs "
                                 "its base and residual: init the state "
                                 "with init_param_avg_state(..., "
                                 "exchange=)")
            with record_function("exchange"), torch.no_grad():
                prev = tree_map(torch.clone,
                                (state.params, state.opt_state))
        losses, held = [], []
        for r, loss, grads in _per_replica_grads(
                loss_fn, state.params, batch, cdt, scale, microbatch):
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
                if group is not None:
                    finite = group.all_true(finite)
                for r, grads in enumerate(held):
                    update_replica_(optimizer, grads, state.params,
                                    state.opt_state, r, lr, finite=finite,
                                    inv_scale=inv)
                ns = next_loss_scale_state(numerics, ns, finite)
        # exchange & average params AND optimizer state (paper fn. 3)
        if sync:
            with record_function("exchange"), torch.no_grad():
                if delay == 0:
                    exchanger.average_((state.params, state.opt_state))
                else:
                    _delayed_exchange_(exchanger, prev,
                                       (state.params, state.opt_state),
                                       state.exchange)
            del prev
        loss = torch.stack(losses).mean()
        if group is not None:
            loss = group.mean(loss)
        return (TrainState(state.params, state.opt_state, state.step + 1,
                           state.exchange, ns), loss)

    return step


def make_param_avg_step(loss_fn: Callable, optimizer: Optimizer,
                        schedule: Callable, *, strategy="all_reduce",
                        sync_every: int = 1, microbatch: int = 1,
                        delay: int = 0,
                        numerics: Optional[NumericsPolicy] = None):
    """The axis-0 engine.  ``loss_fn(params, batch)`` -> scalar; returns
    ``step(state, batch) -> (state, mean loss)``, which updates
    ``state``'s tensors in place and returns them (see the module's
    docstring).  ``strategy`` is a name, an axis-0 ``Exchanger`` or an
    ``ExchangeConfig`` (which then supplies ``delay`` and
    ``sync_every``).  ``delay=1`` is the one-step-stale exchange;
    ``microbatch`` > 1 accumulates each replica's grads over that many
    slices of its batch.  ``numerics`` engages the policy's
    compute-dtype cast and loss scaling (pair it with
    ``optimizers.for_numerics`` for the fp32 masters); the default or
    fp32 policy leaves the step bit-equal to one built without it."""
    if isinstance(strategy, ExchangeConfig):
        sync_every = strategy.sync_every
        delay = strategy.delay
    exchanger = as_exchanger(strategy)
    if exchanger.is_mesh:
        raise ValueError("make_param_avg_step is the axis-0 engine; use "
                         "make_mesh_param_avg_step for a mesh-bound "
                         "Exchanger")
    return _build_step(loss_fn, optimizer, schedule, exchanger, sync_every,
                       microbatch, delay, numerics)


def make_mesh_param_avg_step(loss_fn: Callable, optimizer: Optimizer,
                             schedule: Callable, *, group: ReplicaGroup,
                             strategy="all_reduce", sync_every: int = 1,
                             microbatch: int = 1, delay: int = 0,
                             numerics: Optional[NumericsPolicy] = None):
    """The mesh engine: the same step on this rank's replica (state
    leaves and the batch keep a leading axis of 1), with the exchange a
    collective over ``group`` (``param_avg.ReplicaGroup``), the
    loss-scaling finite flag ANDed over the ranks by an
    ``all_reduce(MIN)`` and the returned loss the ranks' mean.
    ``sync_every`` skips the collectives on the gated-off steps of every
    rank alike.  One flat group: the reference's two-axis
    ``('pod', 'data')`` layout is not ported (ROADMAP queue A item 12)."""
    if isinstance(strategy, ExchangeConfig):
        sync_every = strategy.sync_every
        delay = strategy.delay
    step = _build_step(loss_fn, optimizer, schedule,
                       as_exchanger(strategy, group), sync_every,
                       microbatch, delay, numerics)

    def mesh_step(state: TrainState, batch):
        r = tree_leaves(batch)[0].shape[0]
        if r != 1:
            raise ValueError(f"the mesh engine runs one replica per rank: "
                             f"the batch carries {r}")
        return step(state, batch)

    return mesh_step


def make_grad_avg_step(loss_fn: Callable, optimizer: Optimizer,
                       schedule: Callable, *,
                       numerics: Optional[NumericsPolicy] = None):
    """The modern baseline: one params copy (``init_grad_avg_state``), the
    loss a mean over the global batch, so the grads are the batch's
    mean.  The step is the param-avg step at R = 1 on views of the state
    with a replica axis of 1 (no exchange), so it updates in place and
    keeps the same numerics contract."""
    inner = _build_step(loss_fn, optimizer, schedule, Exchanger("none"), 1,
                        1, 0, numerics)

    def up(tree):
        return tree_map(lambda x: x.unsqueeze(0), tree)

    def step(state: TrainState, batch):
        out, loss = inner(TrainState(up(state.params), up(state.opt_state),
                                     state.step, None, state.numerics),
                          up(batch))
        return TrainState(state.params, state.opt_state, out.step,
                          state.exchange, out.numerics), loss

    return step


def make_eval_step(metric_fn: Callable, *, replica_axis: bool = True):
    """``metric_fn(params, batch)`` -> dict of scalar metrics.  With
    ``replica_axis`` (the param-avg engines) on the averaged model: the
    fp32 mean over the replica axis, cast back (the ensemble the paper
    reports).  Batches carry no replica axis."""

    def eval_step(params, batch):
        with torch.no_grad():
            if replica_axis:
                params = tree_map(
                    lambda x: x.float().mean(0).to(x.dtype), params)
            return metric_fn(params, batch)

    return eval_step


def make_serve_step(decode_fn: Callable):
    """``decode_fn(params, cache, tokens, pos)`` -> (logits, cache); the
    greedy serving step feeds back the argmax token."""

    def step(params, cache, tokens, pos):
        logits, cache = decode_fn(params, cache, tokens, pos)
        next_tok = logits[:, -1:].argmax(dim=-1).to(tokens.dtype)
        return next_tok, cache

    return step


def local_state(state: TrainState, rank: int) -> TrainState:
    """Rank ``rank``'s (1, ...) rows of an (R, ...) state, as contiguous
    copies; 0-d leaves and the step as they are."""
    return tree_map(lambda x: x[rank:rank + 1].clone()
                    if torch.is_tensor(x) and x.dim() else x, state)


def gather_state(state: TrainState, group: ReplicaGroup):
    """Every rank's (1, ...) rows gathered into the one-process engine's
    (R, ...) layout, on the host of rank 0 (None on the others); 0-d
    leaves and the step are rank 0's.  Every rank must call it."""
    def one(x):
        if x.dim() == 0:
            return x.cpu()
        parts = group.all_gather(x)
        return torch.cat([p.cpu() for p in parts]) if group.rank == 0 \
            else None
    out = tree_map(lambda x: one(x) if torch.is_tensor(x) else x, state)
    return out if group.rank == 0 else None


def reshape_for_replicas(batch, n_replicas: int):
    """(B, ...) host batch -> (R, B/R, ...)."""
    def f(x):
        b = x.shape[0]
        if b % n_replicas:
            raise ValueError(f"batch {b} does not split into {n_replicas} "
                             "replicas")
        return x.reshape((n_replicas, b // n_replicas) + tuple(x.shape[1:]))
    return tree_map(f, batch)
