"""Replica exchange-and-average — the paper's §2.2 / Fig. 2 (the
counterpart of ``repro/core/param_avg.py``).

Two engines share one ``Exchanger``:

* **axis-0 engine** (``group=None``): replicated state carries an explicit
  leading axis R on every leaf, and each strategy is a plain tensor
  program over axis 0.  The one-process trainer runs it.
* **mesh engine** (``group=`` a ``ReplicaGroup``): each replica is one
  rank of a ``torch.distributed`` process group, its leaves keep a leading
  axis of 1, and each strategy is the collective its name promises
  (``EXPECTED_COLLECTIVE``).

Strategies:

  ``all_reduce``  mean across replicas          -> ``all_reduce`` (SUM,
                                                   then divide)
  ``ring``        R-1 neighbour shifts,         -> ``batch_isend_irecv``
                  accumulated (the paper's         chain
                  sequential copies around a ring)
  ``pairwise``    log2(R) hypercube exchange+   -> ``batch_isend_irecv``
                  average rounds (R=2 is the       pairs
                  paper's Fig. 2)
  ``none``        no synchronization (local SGD / sync-every-k)

All are exact means for power-of-two R and differ only in their schedule.
The same function is applied to the params and to the optimizer state
(the momentum), per the paper's footnote 3.

Compression lowers the exchanged volume:

  ``none``  full-precision dense exchange (the paper's path)
  ``bf16``  the wire dtype is bf16
  ``topk``  top-k-magnitude sparsification of the delta from the shared
            consensus ``base``, with error-feedback residuals (what top-k
            drops this step is carried into the next step's delta).
            Stateful: base and residual ride on ``TrainState.exchange``
            under the delay=1 exchange; an all-gather of k values and k
            int32 indices per replica, so it composes with ``all_reduce``
            only.

``average`` is the stateless whole-value exchange (none/bf16);
``average_delta`` the stateful compressed-delta exchange (none/bf16/topk,
with residuals) of the delayed path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_map

STRATEGIES = ("all_reduce", "ring", "pairwise", "none")
COMPRESSIONS = ("none", "bf16", "topk")
CHUNK = 1 << 24   # elements per replica that one pass over a leaf touches

# the torch.distributed call each strategy's mesh exchange makes (None:
# no communication); topk below 1.0 makes an ``all_gather`` instead
EXPECTED_COLLECTIVE = {"all_reduce": "all_reduce",
                       "ring": "batch_isend_irecv",
                       "pairwise": "batch_isend_irecv",
                       "none": None}


def _check_pow2(r: int) -> None:
    if r & (r - 1):
        raise ValueError(f"pairwise needs power-of-two replicas, got {r}")


# ------------------------------------------------------ axis-0 engine --

def _avg_all_reduce(x):
    return x.mean(dim=0, keepdim=True).expand_as(x)


def _avg_ring(x):
    r = x.shape[0]
    acc = x
    cur = x
    for _ in range(r - 1):
        cur = torch.roll(cur, shifts=1, dims=0)     # neighbour pass
        acc = acc + cur
    return acc / r


def _avg_pairwise(x):
    r = x.shape[0]
    _check_pow2(r)
    idx = torch.arange(r, device=x.device)
    dim = 1
    while dim < r:
        partner = idx ^ dim                         # hypercube neighbour
        x = 0.5 * (x + x.index_select(0, partner))
        dim <<= 1
    return x


_FNS = {"all_reduce": _avg_all_reduce, "ring": _avg_ring,
        "pairwise": _avg_pairwise}


# -------------------------------------------------------- mesh engine --
# x is one rank's replica (a leading axis of 1); the replica index is the
# rank.  Each returns a new tensor on x's device.

@dataclasses.dataclass(frozen=True, eq=False)
class ReplicaGroup:
    """The mesh engine's replica axis: ``size`` ranks of the process
    group ``group`` (None: the default group), one replica each, this
    process being ``rank``.  ``staged``: the backend takes host tensors
    only (gloo beside CUDA compute), so each collective copies its
    operands into pinned host buffers and its result back."""
    rank: int
    size: int
    group: Any = None
    staged: bool = False

    def wire(self, x):
        """A tensor the backend takes, holding ``x``'s values, that the
        collective may overwrite."""
        if self.staged:
            return torch.empty(x.shape, dtype=x.dtype,
                               pin_memory=True).copy_(x)
        return x.clone()

    def back(self, y, like):
        return y.to(like.device) if self.staged else y

    def all_reduce(self, x, op=dist.ReduceOp.SUM):
        y = self.wire(x)
        dist.all_reduce(y, op=op, group=self.group)
        return self.back(y, x)

    def all_gather(self, x) -> list:
        y = self.wire(x)
        outs = [torch.empty_like(y) for _ in range(self.size)]
        dist.all_gather(outs, y, group=self.group)
        return [self.back(o, x) for o in outs]

    def swap(self, x, dst: int, src: int):
        """Send ``x`` to rank ``dst`` while receiving its like from rank
        ``src``; returns what was received."""
        send = self.wire(x)
        recv = torch.empty_like(send)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, self.group),
            dist.P2POp(dist.irecv, recv, src, self.group)])
        for req in reqs:
            req.wait()
        return self.back(recv, x)

    def all_true(self, flag) -> torch.Tensor:
        """A 0-d bool flag ANDed over the ranks (MIN over 0/1 ints)."""
        return self.all_reduce(flag.to(torch.int32).reshape(1),
                               dist.ReduceOp.MIN)[0] > 0

    def mean(self, x):
        """The ranks' mean of ``x`` (SUM, then divide)."""
        return self.all_reduce(x) / self.size


def _rank_all_reduce(x, g: ReplicaGroup):
    return g.mean(x)


def _rank_ring(x, g: ReplicaGroup):
    r = g.size
    acc = x
    cur = x
    for _ in range(r - 1):
        # the same direction as the axis-0 roll(+1): rank i receives from
        # rank i - 1
        cur = g.swap(cur, (g.rank + 1) % r, (g.rank - 1) % r)
        acc = acc + cur
    return acc / r


def _rank_pairwise(x, g: ReplicaGroup):
    _check_pow2(g.size)
    dim = 1
    while dim < g.size:
        partner = g.rank ^ dim
        x = 0.5 * (x + g.swap(x, partner, partner))
        dim <<= 1
    return x


_RANK_FNS = {"all_reduce": _rank_all_reduce, "ring": _rank_ring,
             "pairwise": _rank_pairwise}


# ---------------------------------------------------------- Exchanger --

@dataclasses.dataclass(frozen=True)
class Exchanger:
    """One exchange schedule bound to an engine: ``group=None`` the axis-0
    engine (leaves carry the replica axis R), a ``ReplicaGroup`` the mesh
    engine (leaves are this rank's replica, a leading axis of 1).

    ``compression`` lowers the exchanged volume (module docstring).
    ``topk_frac`` is the kept fraction per leaf for ``topk`` (1.0 keeps
    everything: identity compression, bit-equal to ``none`` because it
    takes the same dense path)."""
    strategy: str = "all_reduce"
    compression: str = "none"
    topk_frac: float = 0.01
    group: Optional[ReplicaGroup] = None

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; "
                             f"one of {STRATEGIES}")
        if self.compression not in COMPRESSIONS:
            raise ValueError(f"unknown compression {self.compression!r}; "
                             f"one of {COMPRESSIONS}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(f"topk_frac must be in (0, 1], "
                             f"got {self.topk_frac}")
        if self.compression == "topk" and self.strategy not in (
                "all_reduce", "none"):
            raise ValueError(
                "topk compression is an all-gather schedule (k values + k "
                "indices per replica); ring/pairwise permute dense buffers "
                f"— use bf16 with strategy {self.strategy!r}")

    @property
    def is_mesh(self) -> bool:
        return self.group is not None

    @property
    def expected_collective(self) -> Optional[str]:
        """The ``torch.distributed`` call the mesh exchange makes."""
        if self.strategy != "none" and self.compression == "topk" \
                and self.topk_frac < 1.0:
            return "all_gather"
        return EXPECTED_COLLECTIVE[self.strategy]

    @property
    def is_stateful(self) -> bool:
        """True when the exchange needs base and residual buffers on the
        train state (the delayed compressed-delta path)."""
        return self.compression != "none"

    def topk_k(self, n: int) -> int:
        """Entries kept of a replica's leaf of ``n`` (the reference's
        formula)."""
        return max(1, int(round(self.topk_frac * n)))

    def _wire_cast(self, x):
        """Cast to the wire dtype (what the collective moves)."""
        return x.to(torch.bfloat16 if self.compression == "bf16"
                    else torch.float32)

    def _mean(self, x):
        """Dense mean across the replicas in ``x``'s dtype."""
        if self.is_mesh:
            return _RANK_FNS[self.strategy](x, self.group)
        return _FNS[self.strategy](x)

    def _check_stateless(self):
        if self.compression == "topk":
            raise ValueError(
                "topk compression is stateful (delta from a shared base + "
                "error-feedback residual); use average_delta via the "
                "delay=1 overlapped exchange (core/steps.py)")

    def average(self, tree):
        """Stateless exchange+average of whole values (params or optimizer
        state), ``none`` or ``bf16``; 0-d leaves stay as they are.  Each
        leaf is averaged in its wire dtype and cast back through fp32, as
        the reference's ``Exchanger.average`` does.  Returns new
        contiguous tensors."""
        if self.strategy == "none":
            return tree
        self._check_stateless()
        return tree_map(lambda x: x if x.dim() == 0 else
                        self.average_leaf(x).contiguous(), tree)

    def average_leaf(self, x):
        """One tensor's stateless average (replica axis first), in its
        own dtype."""
        return self._mean(self._wire_cast(x)).float().to(x.dtype)

    def average_(self, tree) -> None:
        """``average`` written into the tree's own (contiguous) tensors,
        one ``chunks`` block at a time, so no fp32 copy of a whole leaf
        is made (``copy_`` casts back, as ``average``'s ``to`` does)."""
        if self.strategy == "none":
            return
        self._check_stateless()
        for x in tree_leaves(tree):
            if x.dim():
                for c in chunks(x):
                    c.copy_(self.average_leaf(c))

    # ------------------------------------------------- compressed deltas --
    def _topk_mean(self, d, k: int):
        """(mean of the replicas' top-k-sparsified deltas, this replica's
        dense top-k selection ``kept``) for ``d`` (fp32, replica axis
        first).  Each replica selects over its whole leaf; the kept
        values are scatter-added replica by replica in replica order
        (unique indices within a replica, so no atomics), the
        reference's order, on both engines.  The mesh engine all-gathers
        k values and k int32 indices per rank."""
        r = d.shape[0]
        flat = d.reshape(r, -1)
        n = flat.shape[1]
        idx = torch.topk(flat.abs(), k, dim=1, sorted=False).indices
        vals = torch.gather(flat, 1, idx)
        kept = torch.zeros_like(flat).scatter_(1, idx, vals)
        if self.is_mesh:
            allv = self.group.all_gather(vals[0])
            alli = [i.long() for i in self.group.all_gather(
                idx[0].to(torch.int32))]
            reps = self.group.size
        else:
            allv, alli, reps = list(vals), list(idx), r
        total = torch.zeros(n, dtype=d.dtype, device=d.device)
        for v, i in zip(allv, alli):
            total[i] += v
        mean = (total / reps).expand(r, n).reshape(d.shape)
        return mean, kept.reshape(d.shape)

    def delta(self, x, b, res):
        """One leaf's (or chunk's) compressed-delta exchange::

            d    = (x - base) + residual      # what we owe the consensus
            c    = compress(d)                # what actually moves
            out  = base + collective_mean(c)  # the new consensus
            res' = d - c                      # dropped -> next step

        Returns ``(out in x's dtype, res' fp32)``.  topk selects over
        what it is given, so it takes whole leaves."""
        d = x.float() - b.float() + res
        if self.compression == "topk":
            per_rep = d[0].numel()
            k = self.topk_k(per_rep)
            if k < per_rep:
                avg_c, kept = self._topk_mean(d, k)
                return (b.float() + avg_c).to(x.dtype), d - kept
            # k == n: identity compression.  The residual stays zero, so
            # base + mean(x - base) == mean(x): take the SAME dense
            # whole-value arithmetic as compression "none", bit-equal
            return self._mean(x.float()).float().to(x.dtype), \
                torch.zeros_like(res)
        if self.compression == "bf16":
            c = d.to(torch.bfloat16)
            avg_c = self._mean(c).float()
            return (b.float() + avg_c).to(x.dtype), d - c.float()
        return (b.float() + self._mean(d)).to(x.dtype), torch.zeros_like(res)

    def average_delta(self, tree, base, residual):
        """Stateful compressed exchange of deltas with error feedback
        (``delta`` on every leaf; ``base`` must be replica-identical, the
        previous exchange's output).  0-d leaves are never exchanged.
        Returns ``(averaged_tree, new_residual)``."""
        if self.strategy == "none":
            return tree, residual
        out = tree_map(lambda x, b, r: (x, r) if x.dim() == 0 else
                       self.delta(x, b, r), tree, base, residual)
        return (tree_map(lambda _, p: p[0], tree, out),
                tree_map(lambda _, p: p[1], tree, out))

    def logical_bytes(self, tree, n_replicas: int) -> int:
        """Bytes one replica logically transmits per exchange: ``none``
        full fp32 leaves, ``bf16`` half, ``topk`` k values + k int32
        indices per leaf."""
        total = 0
        for x in tree_leaves(tree):
            if x.dim() == 0 or self.strategy == "none":
                continue
            n = x.numel() // (1 if self.is_mesh else n_replicas)
            if self.compression == "bf16":
                total += 2 * n
            elif self.compression == "topk":
                k = self.topk_k(n)
                total += (4 + 4) * k if k < n else 4 * n
            else:
                total += 4 * n
        return total


def as_exchanger(strategy, group: Optional[ReplicaGroup] = None
                 ) -> Exchanger:
    """A strategy name, an ``ExchangeConfig`` or an ``Exchanger``
    (``group`` binds it to the mesh engine)."""
    if isinstance(strategy, ExchangeConfig):
        return strategy.exchanger(group)
    if isinstance(strategy, Exchanger):
        if group is not None and strategy.group is not group:
            return dataclasses.replace(strategy, group=group)
        return strategy
    return Exchanger(strategy, group=group)


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    """How replicas synchronize, in one frozen value:

    ``strategy``     communication schedule (STRATEGIES)
    ``compression``  wire compression (COMPRESSIONS)
    ``topk_frac``    kept fraction for topk
    ``delay``        0 = synchronous exchange after the update (the
                     paper's path); 1 = one-step-stale exchange of the
                     incoming state, grafted onto the update
                     (core/steps.py)
    ``sync_every``   local SGD: exchange every k-th step only
    """
    strategy: str = "all_reduce"
    compression: str = "none"
    topk_frac: float = 0.01
    delay: int = 0
    sync_every: int = 1

    def __post_init__(self):
        if self.delay not in (0, 1):
            raise ValueError(f"delay must be 0 or 1, got {self.delay}")
        if self.sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, "
                             f"got {self.sync_every}")
        if self.compression == "topk" and self.delay == 0:
            raise ValueError(
                "topk compression needs the delay=1 overlapped exchange "
                "(its error-feedback residual and consensus base live in "
                "TrainState.exchange, which only the delayed path carries)")
        # strategy/compression cross-validation happens in Exchanger
        self.exchanger()

    def exchanger(self, group: Optional[ReplicaGroup] = None) -> Exchanger:
        return Exchanger(self.strategy, compression=self.compression,
                         topk_frac=self.topk_frac, group=group)

    def describe(self) -> str:
        out = f"{self.strategy}/delay{self.delay}/{self.compression}"
        if self.compression == "topk":
            out += f"@{self.topk_frac:g}"
        if self.sync_every != 1:
            out += f"/every{self.sync_every}"
        return out


def exchange_average(tree, strategy="all_reduce"):
    """Average every leaf of a replicated tree over its leading R axis
    (the axis-0 engine's stable entry point)."""
    ex = as_exchanger(strategy)
    if ex.is_mesh:
        raise ValueError("exchange_average is the axis-0 engine; call "
                         "Exchanger.average on each rank for the mesh "
                         "engine")
    return ex.average(tree)


def replicate(tree, n_replicas: int):
    """Give every leaf a leading replica axis (identical copies, as the
    paper initializes both GPUs' models identically)."""
    return tree_map(lambda x: x.unsqueeze(0).repeat(
        (n_replicas,) + (1,) * x.dim()), tree)


def unreplicate(tree):
    """Replica 0 of every leaf (after averaging all are identical)."""
    return tree_map(lambda x: x[0], tree)


def chunks(x, read_only=False):
    """``x`` (a leading replica axis) as (R, n) column blocks of at most
    ``CHUNK`` elements per replica: views to write through (``x`` must
    be contiguous), or ``read_only`` blocks of any layout."""
    flat = x.reshape(x.shape[0], -1) if read_only else \
        x.view(x.shape[0], -1)
    return [flat[:, i:i + CHUNK] for i in range(0, flat.shape[1], CHUNK)]


def replica_spread(tree) -> float:
    """Max abs deviation across replicas: 0 right after a sync step, a
    diagnostic for local-SGD drift.  Taken over ``chunks`` of each leaf,
    so it allocates no fp32 copy of a multi-GB embedding."""
    out = 0.0
    for x in tree_leaves(tree):
        if x.dim():
            for c in chunks(x, read_only=True):
                xf = c.float()
                out = max(out, (xf - xf.mean(0, keepdim=True)).abs().max()
                          .item())
    return out


def mesh_spread(tree, group: ReplicaGroup) -> float:
    """``replica_spread`` across the mesh engine's ranks: the max abs
    deviation of any rank's leaf from the ranks' fp32 mean."""
    out = None
    for x in tree_leaves(tree):
        if x.dim():
            xf = x.float()
            dev = (xf - group.mean(xf)).abs().max().reshape(1)
            out = dev if out is None else torch.maximum(out, dev)
    if out is None:
        return 0.0
    return group.all_reduce(out, dist.ReduceOp.MAX).item()
