"""Replica exchange-and-average — the paper's §2.2 / Fig. 2 (the
counterpart of the reference engine of ``repro/core/param_avg.py``).

Replicated state carries an explicit leading axis R on every leaf, and
each strategy is a plain tensor program over axis 0:

  ``all_reduce``  mean across replicas
  ``ring``        R-1 neighbour shifts, accumulated (the paper's
                  sequential copies around a ring)
  ``pairwise``    log2(R) hypercube exchange+average rounds (R=2 is the
                  paper's Fig. 2: one exchange, then average on both)
  ``none``        no synchronization (local SGD / sync-every-k)

All are exact means for power-of-two R and differ only in their schedule.
The same function is applied to the params and to the optimizer state
(the momentum), per the paper's footnote 3.  The mesh engine, the
``delay=1`` overlapped exchange and wire compression are not ported
(ROADMAP queue A).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import tree_leaves, tree_map

STRATEGIES = ("all_reduce", "ring", "pairwise", "none")
CHUNK = 1 << 24   # elements per replica that one pass over a leaf touches
COMPRESSIONS = ("none", "bf16", "topk")
_NOT_PORTED = ("{what} is not ported yet: see ROADMAP.md queue A (the "
               "overlapped delay=1 exchange and bf16/top-k compression)")


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
    if r & (r - 1):
        raise ValueError(f"pairwise needs power-of-two replicas, got {r}")
    idx = torch.arange(r, device=x.device)
    dim = 1
    while dim < r:
        partner = idx ^ dim                         # hypercube neighbour
        x = 0.5 * (x + x.index_select(0, partner))
        dim <<= 1
    return x


_FNS = {"all_reduce": _avg_all_reduce, "ring": _avg_ring,
        "pairwise": _avg_pairwise}


@dataclasses.dataclass(frozen=True)
class Exchanger:
    """One exchange schedule over the leading replica axis."""
    strategy: str = "all_reduce"

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; "
                             f"one of {STRATEGIES}")

    def average(self, tree):
        """Exchange+average every leaf with a replica axis (0-d leaves,
        replica-identical bookkeeping, stay as they are).  Each leaf is
        averaged in fp32 and cast back to its own dtype, as the
        reference's ``Exchanger.average`` does, so bf16 params average
        without bf16 partial sums.  Returns new contiguous tensors."""
        if self.strategy == "none":
            return tree
        fn = _FNS[self.strategy]
        return tree_map(lambda x: x if x.dim() == 0 else
                        fn(x.float()).to(x.dtype).contiguous(), tree)

    def average_(self, tree) -> None:
        """``average`` written into the tree's own (contiguous) tensors,
        one ``chunks`` block at a time, so no fp32 copy of a whole leaf
        is made (``copy_`` casts back, as ``average``'s ``to`` does)."""
        if self.strategy == "none":
            return
        fn = _FNS[self.strategy]
        for x in tree_leaves(tree):
            if x.dim():
                for c in chunks(x):
                    c.copy_(fn(c.float()))


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    """How replicas synchronize: ``strategy`` (``STRATEGIES``) and
    ``sync_every`` (local SGD: exchange every k-th step only).  The
    reference's ``delay=1`` and ``compression`` raise here."""
    strategy: str = "all_reduce"
    compression: str = "none"
    delay: int = 0
    sync_every: int = 1

    def __post_init__(self):
        if self.delay not in (0, 1):
            raise ValueError(f"delay must be 0 or 1, got {self.delay}")
        if self.sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, "
                             f"got {self.sync_every}")
        if self.compression not in COMPRESSIONS:
            raise ValueError(f"unknown compression {self.compression!r}; "
                             f"one of {COMPRESSIONS}")
        if self.delay == 1:
            raise NotImplementedError(_NOT_PORTED.format(
                what="the delay=1 overlapped exchange"))
        if self.compression != "none":
            raise NotImplementedError(_NOT_PORTED.format(
                what=f"{self.compression} exchange compression"))
        self.exchanger()

    def exchanger(self) -> Exchanger:
        return Exchanger(self.strategy)

    def describe(self) -> str:
        out = f"{self.strategy}/delay{self.delay}/{self.compression}"
        if self.sync_every != 1:
            out += f"/every{self.sync_every}"
        return out


def as_exchanger(strategy) -> Exchanger:
    """A strategy name, an ``ExchangeConfig`` or an ``Exchanger``."""
    if isinstance(strategy, ExchangeConfig):
        return strategy.exchanger()
    if isinstance(strategy, Exchanger):
        return strategy
    return Exchanger(strategy)


def replicate(tree, n_replicas: int):
    """Give every leaf a leading replica axis (identical copies, as the
    paper initializes both GPUs' models identically)."""
    return tree_map(lambda x: x.unsqueeze(0).repeat(
        (n_replicas,) + (1,) * x.dim()), tree)


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
