"""Shared-prefix KV blocks: the ring cache cut into ref-counted,
fixed-size pool blocks (the counterpart of ``repro/serving/blocks.py``).

Instead of one private (capacity,) ring per slot, the engine owns ONE
pool of ``num_blocks`` blocks of ``block_size`` ring positions each, and
a per-slot **block table** (slots, capacity/bs) mapping logical ring
slot ``s`` of a row onto ``pool[table[row, s // bs], s % bs]``.  The
ring arithmetic is untouched; only the physical place of a slot's bytes
moves, which is why the decode kernel takes the table and otherwise runs
the ring's loop (``kernels/decode_attention``).

  sharing   the K/V of prompt position p depends only on tokens <= p, so
            two requests with the same prompt PREFIX produce bit-equal
            cache blocks.  ``BlockManager`` chain-hashes each full
            ``block_size`` prompt chunk (h_j = H(h_{j-1}, chunk_j)) and
            points a new row's table at already-filled blocks: prefill
            still runs (the suffix needs its logits) but the pool holds
            ONE copy of the shared prefix.
  prefill   an EXACT full-prompt repeat (greedy engines) admits with no
  -once     forward at all: the manager kept the first sampled token and
            a snapshot of the tail block at first admission; the new row
            shares the full chunks and gets a copy-on-write clone of the
            tail snapshot (its decode will write into that block).
  safety    block 0 is the TRASH block and is never allocated: a retired
            slot's table is reset to all zeros, so the garbage its
            inactive row keeps decoding lands in block 0, which no live
            table references.  Live rows never write a shared block:
            decode writes sit at positions >= prompt_len, which per-admit
            full allocation places in private blocks, and rows retire
            before the ring wraps (the engine's ``_hit_limits``).

The manager is pure host bookkeeping (refcounts, free list, hash
indices).  Device data moves only in ``write_prefill`` (scatter a
prefilled contiguous ring into the row's blocks) and ``copy_block`` (COW
and snapshot clones), and both write the pool in place.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import models

TRASH = 0     # block 0: retired rows write here, nobody reads it


def _chain(prev: bytes, chunk) -> bytes:
    return hashlib.sha1(prev + np.asarray(chunk, np.int32).tobytes()).digest()


@dataclasses.dataclass
class Admission:
    """One row's placement.  ``table`` is the full per-admit allocation
    (capacity/bs entries, shared prefix first).  When ``first_token`` is
    set the prefill forward is SKIPPED (exact-prompt hit): ``cow`` clones
    the tail snapshot into this row's private block.  Otherwise the
    engine prefills, scatters, then calls ``BlockManager.finish`` to
    register the new chunks and the snapshot."""
    table: List[int]
    n_shared: int                      # shared full-prefix chunks
    prompt_len: int
    cow: List[Tuple[int, int]]         # (dst, src) block copies to run
    first_token: Optional[int] = None  # set => zero-forward admission
    new_chunks: List[Tuple[bytes, int]] = dataclasses.field(
        default_factory=list)
    pkey: Optional[bytes] = None
    snapshot: Optional[int] = None     # block to clone the tail into


class BlockManager:
    """Host-side allocator of the shared block pool."""

    def __init__(self, num_blocks: int, block_size: int,
                 prefill_once: bool = True):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (trash + 1), "
                             f"got {num_blocks}")
        self.nb, self.bs = num_blocks, block_size
        # first-token reuse is sound only when sampling is deterministic
        # given the prompt (greedy); chunk sharing is sound regardless
        self.prefill_once = prefill_once
        self.free: List[int] = list(range(num_blocks - 1, TRASH, -1))
        self.ref: Dict[int, int] = {}
        self.chunks: Dict[bytes, int] = {}      # chain hash -> block
        self._rev: Dict[int, bytes] = {}        # block -> chain hash
        self.prompts: Dict[bytes, Tuple[int, Optional[int]]] = {}
        self.prefills_skipped = 0
        self.peak = 0                      # high-water blocks in use

    def _alloc(self) -> int:
        b = self.free.pop()
        self.ref[b] = 1
        self.peak = max(self.peak, self.in_use)
        return b

    def _share(self, b: int) -> int:
        self.ref[b] += 1
        return b

    def _unref(self, b: int) -> None:
        self.ref[b] -= 1
        if self.ref[b] == 0:
            del self.ref[b]
            h = self._rev.pop(b, None)
            if h is not None:
                self.chunks.pop(h, None)
            self.free.append(b)

    def _ensure(self, needed: int, protect: Optional[bytes]) -> bool:
        """Free snapshot-only pool space (evict cached prompts) until
        ``needed`` blocks are allocatable.  Never evicts ``protect``."""
        while len(self.free) < needed:
            victim = next((k for k in self.prompts if k != protect), None)
            if victim is None:
                return False
            _, snap = self.prompts.pop(victim)
            if snap is not None:
                self._unref(snap)
        return True

    @property
    def in_use(self) -> int:
        return self.nb - 1 - len(self.free)

    def _hashes(self, prompt) -> Tuple[List[bytes], bytes]:
        hs, h = [], b"ring"
        for i in range(len(prompt) // self.bs):
            h = _chain(h, prompt[i * self.bs:(i + 1) * self.bs])
            hs.append(h)
        pkey = _chain(h, prompt[len(hs) * self.bs:])
        return hs, pkey

    def admit(self, prompt, n_k: int) -> Optional[Admission]:
        """Place one row (prompt = int sequence; n_k = capacity/bs table
        length).  Returns None when the pool cannot host the row now: the
        engine defers the request instead of failing it."""
        prompt = list(map(int, prompt))
        n_full = len(prompt) // self.bs
        tail = len(prompt) - n_full * self.bs
        hs, pkey = self._hashes(prompt)

        cached = self.prefill_once and pkey in self.prompts and \
            all(h in self.chunks for h in hs)
        if cached:
            first, snap = self.prompts[pkey]
            if not self._ensure(n_k - n_full, protect=pkey):
                return None
            table = [self._share(self.chunks[h]) for h in hs]
            cow = []
            if tail:
                table.append(self._alloc())
                cow.append((table[-1], snap))
            while len(table) < n_k:
                table.append(self._alloc())
            self.prefills_skipped += 1
            return Admission(table=table, n_shared=n_full,
                             prompt_len=len(prompt), cow=cow,
                             first_token=first)

        j = 0
        while j < n_full and hs[j] in self.chunks:
            j += 1
        register = self.prefill_once and pkey not in self.prompts
        need_snap = register and tail > 0
        if not self._ensure(n_k - j + int(need_snap), protect=pkey):
            return None
        table = [self._share(self.chunks[h]) for h in hs[:j]]
        table += [self._alloc() for _ in range(n_k - j)]
        return Admission(
            table=table, n_shared=j, prompt_len=len(prompt), cow=[],
            new_chunks=[(hs[i], table[i]) for i in range(j, len(hs))],
            pkey=pkey if register else None,
            snapshot=self._alloc() if need_snap else None)

    def finish(self, adm: Admission, first_token: int) -> None:
        """Register what prefill just filled: the row's fresh full chunks
        become shareable, and (greedy engines) the exact prompt maps to
        (first sampled token, tail snapshot) for prefill-once."""
        for h, b in adm.new_chunks:
            self.chunks[h] = b
            self._rev[b] = h
        if adm.pkey is not None:
            self.prompts[adm.pkey] = (int(first_token), adm.snapshot)

    def release(self, adm: Admission) -> None:
        for b in adm.table:
            self._unref(b)


# ------------------------------------------------------------ device ops ----

def init_blocked_state(cfg, num_blocks: int, block_size: int, slots: int,
                       *, device=None) -> models.DecodeState:
    """The pool-shaped DecodeState: every ring leaf built as a batch of
    ``num_blocks`` rows of capacity ``block_size``, i.e. the pool IS a
    ring cache whose batch axis means 'block'.  ``pos`` stays per slot;
    the table maps between the two."""
    cache = models.init_decode_cache(cfg, num_blocks, block_size,
                                     device=device)
    pos = torch.zeros((slots,), dtype=torch.int32,
                      device=cache["blocks"][0]["k"].device)
    return models.DecodeState(cache=cache, pos=pos)


def write_prefill(state: models.DecodeState, sub: models.DecodeState,
                  table_row, slot: int, block_size: int):
    """Scatter a freshly prefilled CONTIGUOUS ring (batch 1, capacity
    n_k * bs) into the row's blocks, in place, and set the slot's
    position.  Shared prefix blocks are rewritten with bit-identical
    bytes (same chunk and prefix, same K/V)."""
    n_k = len(table_row)
    ids = torch.as_tensor(list(table_row), dtype=torch.long,
                          device=state.pos.device)

    def one(pool, s, axis):
        if axis:
            chunks = s[:, 0, :n_k * block_size].reshape(
                (s.shape[0], n_k, block_size) + tuple(s.shape[3:]))
            pool[:, ids] = chunks.to(pool.dtype)
        else:
            chunks = s[0, :n_k * block_size].reshape(
                (n_k, block_size) + tuple(s.shape[2:]))
            pool[ids] = chunks.to(pool.dtype)

    models.map_cache(one, state.cache, sub.cache)
    state.pos[slot] = sub.pos[0]


def copy_block(state: models.DecodeState, dst: int, src: int) -> None:
    """Clone one pool block across every leaf, in place (COW and
    snapshots)."""

    def one(pool, axis):
        if axis:
            pool[:, dst] = pool[:, src]
        else:
            pool[dst] = pool[src]

    models.map_cache(one, state.cache)
