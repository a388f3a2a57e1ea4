"""Slot-based continuous-batching serving engine (the counterpart of
``repro/serving/engine.py``), for image classification (the conv family)
and for the dense, moe (mixture-of-experts FFN), ssm (RWKV6) and hybrid
(RG-LRU + local attention) LMs.

The engine keeps ``slots`` rows and runs the reference's admission
fixpoint on every ``step``:

  retire   rows whose token budget is met (or whose ring is full) free
           their slot and hand back their ``Result``;
  admit    queued requests fill the free slots.  A conv request is one
           raw image: the freshly admitted images are classified by ONE
           batched forward, zero-padded up to a power-of-two bucket, and
           retire at the next pass.  An LM prompt is right-padded to a
           length BUCKET and prefilled (per-row ``length`` keeps the
           padded prefill equal to an unpadded one); its fresh state is
           scattered into the slot with ``models.write_slots``;
  decode   (LM) one dispatch of ``ticks_per_dispatch`` decode ticks for
           every slot at once: each consumes its last token at its own
           position (``DecodeState.pos`` is per row) and samples the
           next.  The sampled tokens stay on the device between ticks;
           the host reads them once per dispatch (``_to_host``).
           Inactive slots decode garbage into their own rows; the next
           admission's ``write_slots`` overwrites every leaf of its row,
           the recurrent state as well as the ring.

With ``draft_params`` / ``draft_cfg`` the engine decodes speculatively
(``serving/spec_decode.py``, greedy only): admission prefills the draft
too, into its own DecodeState, and each dispatch is one round in which
the draft proposes ``spec_tokens`` tokens and the target verifies them in
one chunked forward; a row emits 1 to ``spec_tokens + 1`` tokens a
dispatch, the plain engine's stream.

With ``block_size > 0`` the KV cache is a shared, ref-counted pool of
blocks read through per-slot block tables (``serving/blocks.py``):
requests with a common prompt prefix share its blocks, and an exact
repeat of a prompt (greedy engines) admits with no forward at all.  The
pool holds attention K/V only, so it serves the dense and moe families
alone (full attention only, as the reference's).

A moe prompt's prefill dispatches at the configured, dropping, capacity
factor, so which tokens an expert drops depends on the tokens that share
the forward: the engine batches and pads prompts exactly as the
reference's does (one right-padded bucket per admission), which is what
keeps its streams equal to the reference's.  Decode is dropless.

The multi-process tier (``serving/tier.py``, ``serving/router.py``) moves
live rows between engines: ``export_slot`` snapshots one row (its
DecodeState slice, last token, sampling rid and bookkeeping),
``import_snapshot`` replays a snapshot into a free slot of a same-shape
engine and continues its stream, and ``drain`` stops admission and
hands back every live row's snapshot and the queue.

Everything runs under ``torch.inference_mode()``, and the decode state
is written in place.  The replica mesh (ROADMAP queue A item 12) and the
LM families the port has not got (item 8: vlm, encdec) raise.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import models, numerics
from repro_torch.serving import blocks as blk
from repro_torch.serving import sampling, spec_decode
from repro_torch.tree import tree_map

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512)


def _to_host(x):
    """THE device-to-host read of the decode loop: ``step()`` calls it
    exactly once per dispatch, on one packed tensor, the token block and
    the retire flags together: (2, slots, K), or a speculative round's
    (slots, 2(γ+1)+1) with the accept counts (the tests count calls to
    this hook)."""
    return x.cpu().numpy()


def buckets_for(capacity: int) -> tuple:
    """The prompt-length buckets of an engine of ``capacity``: any prompt
    that fits the ring is admissible."""
    return tuple(b for b in DEFAULT_BUCKETS if b < capacity) + (capacity,)


def bucket_of(buckets, n: int) -> int:
    """The smallest bucket that holds a prompt of ``n`` tokens."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest bucket "
                     f"{buckets[-1]} (the capacity)")


def prefill_prompt(params, cfg, prompt, rid: int, *, bucket: int,
                   capacity: int, seed: int, temperature: float, top_k: int,
                   draft=None):
    """``prompt`` right-padded to ``bucket`` through ``models.prefill``
    (batch 1): (the first token, a device (1,) tensor sampled at position
    ``len(prompt)`` with request id ``rid``; the prefilled sub-state; the
    draft's, or None when ``draft`` (params, cfg) is None).  The engine's
    admission and the tier's prefill worker both run this."""
    device = params["embed"]["tok"].device
    toks = torch.zeros((1, bucket), dtype=torch.long)
    toks[0, :len(prompt)] = torch.as_tensor(prompt, dtype=torch.long)
    toks = toks.to(device)
    length = torch.full((1,), len(prompt), dtype=torch.int32, device=device)
    # a named range, so a profiler trace can book prefills apart
    with torch.profiler.record_function("prefill"):
        logits, sub = models.prefill(params, cfg, toks, capacity,
                                     length=length)
        dsub = None
        if draft is not None:
            # the draft consumes the same prompt, so its state sits at the
            # same position; its first token is discarded: the stream's
            # first token is the target's
            _, dsub = models.prefill(draft[0], draft[1], toks, capacity,
                                     length=length)
    first = sampling.sample_slots(
        seed, torch.full((1,), rid, device=device), length,
        logits[:, len(prompt) - 1], temperature, top_k)
    return first, sub, dsub


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: see ROADMAP.md "
                               f"queue A {item}")


class DrainingError(RuntimeError):
    """``submit`` on a draining engine: it is handing its live rows to
    peers and takes no new work (the router places the request on a
    peer)."""


@dataclasses.dataclass
class Request:
    """One request.  For the conv family ``image`` IS the request (an
    (image_size, image_size, in_channels) array; the prompt is ignored
    and the result is one class id); for an LM ``prompt`` is an int
    sequence and ``max_new_tokens`` the budget."""
    prompt: Any = ()
    max_new_tokens: int = 32
    image: Any = None
    rid: int = -1                      # assigned by submit()


@dataclasses.dataclass
class Result:
    rid: int
    prompt_len: int
    tokens: List[int]                  # generated ids (first from prefill)
    t_submit: float
    t_first: float                     # first token emitted
    t_done: float
    draft_proposed: int = 0            # spec decode: draft tokens offered
    draft_accepted: int = 0            # ... of which the target kept

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_submit

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit

    @property
    def acceptance(self) -> float:
        return self.draft_accepted / max(self.draft_proposed, 1)


class ServingEngine:
    """Serves ``params`` for ``cfg`` on their device: an ``AlexNet``
    module (NHWC images) for the conv family, a params tree for an LM;
    with ``draft_params`` / ``draft_cfg`` (an LM params tree and its
    config, on the same device) it decodes speculatively, ``spec_tokens``
    draft tokens a round."""

    def __init__(self, params, cfg, *, slots: int = 4, capacity: int = 256,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_id: Optional[int] = None, seed: int = 0,
                 ticks_per_dispatch: int = 1, block_size: int = 0,
                 num_blocks: int = 0, draft_params=None, draft_cfg=None,
                 spec_tokens: int = 4, mesh=None):
        if cfg.family not in models.FAMILIES:
            raise _not_ported(f"serving the {cfg.family!r} family "
                              f"({cfg.name})", "item 8")
        if mesh is not None:
            raise _not_ported("the replica mesh", "item 12")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if ticks_per_dispatch < 1:
            raise ValueError(f"ticks_per_dispatch must be >= 1, "
                             f"got {ticks_per_dispatch}")
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError("speculative decoding needs BOTH draft_params "
                             "and draft_cfg (or neither)")
        self.draft_params, self.draft_cfg = draft_params, draft_cfg
        self.spec_tokens = int(spec_tokens)
        self.spec_proposed = 0         # draft tokens offered, engine-wide
        self.spec_accepted = 0         # ... kept by the target
        if draft_cfg is not None:
            if self.spec_tokens < 0:
                raise ValueError(
                    f"spec_tokens must be >= 0, got {spec_tokens}")
            spec_decode.check_spec_pair(cfg, draft_cfg,
                                        temperature=temperature,
                                        ticks=ticks_per_dispatch)
        self.params, self.cfg, self.slots = params, cfg, slots
        self.capacity, self.ticks = capacity, ticks_per_dispatch
        self.temperature, self.top_k, self.eos_id = temperature, top_k, eos_id
        self.seed = seed
        self.buckets = buckets_for(capacity)
        self._draining = False
        self._active: List[Optional[Request]] = [None] * slots
        self._results: Dict[int, Result] = {}
        self._queue: collections.deque = collections.deque()
        self._next_rid = 0
        self._buckets_used: set = set()
        self.decode_steps = 0          # model ticks run (K per dispatch)
        self.dispatches = 0            # decode dispatches
        self.block_size = int(block_size)
        self.block_mgr = None
        self.table = None
        if cfg.family == "conv":
            self.device = next(params.parameters()).device
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(seed)
            return
        self.device = params["embed"]["tok"].device
        with torch.inference_mode():
            self._init_lm_state(num_blocks)

    def _init_lm_state(self, num_blocks: int) -> None:
        cfg, slots, dev = self.cfg, self.slots, self.device
        if self.block_size > 0:
            if cfg.family not in ("dense", "moe"):
                raise ValueError(
                    f"block-table caches need a pure-attention family "
                    f"(dense/moe), got {cfg.family!r} ({cfg.name}): the "
                    "pool holds K/V blocks, not recurrent state")
            if cfg.sliding_window is not None:
                raise NotImplementedError(
                    "block-table caches need full attention: a windowed "
                    "ring (cap < seq) wraps and would overwrite shared "
                    "blocks")
            if self.ticks != 1 or self.draft_cfg is not None:
                raise ValueError("block-table serving composes with "
                                 "neither multi-tick dispatch (rows must "
                                 "retire before the ring wraps) nor "
                                 "speculative decoding")
            if self.capacity % self.block_size:
                raise ValueError(f"capacity {self.capacity} not a multiple "
                                 f"of block_size {self.block_size}")
            self.n_k = self.capacity // self.block_size
            # default pool: fully private provisioning + the trash block
            nb = int(num_blocks) or slots * self.n_k + 1
            self.block_mgr = blk.BlockManager(
                nb, self.block_size, prefill_once=self.temperature == 0.0)
            self.table = torch.zeros((slots, self.n_k), dtype=torch.int32,
                                     device=dev)
            self._slot_adm: List[Optional[blk.Admission]] = [None] * slots
            self.state = blk.init_blocked_state(cfg, nb, self.block_size,
                                                slots, device=dev)
        else:
            self.state = models.init_decode_state(cfg, slots, self.capacity,
                                                  device=dev)
        self.draft_state = None if self.draft_cfg is None else \
            models.init_decode_state(self.draft_cfg, slots, self.capacity,
                                     device=dev)
        self.last_tok = torch.zeros((slots, 1), dtype=torch.long, device=dev)
        self.slot_rids = torch.zeros((slots,), dtype=torch.long, device=dev)

    # ----------------------------------------------------------- buckets ----

    def _bucket(self, n: int) -> int:
        return bucket_of(self.buckets, n)

    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill shapes run: the reference's compile count."""
        return len(self._buckets_used)

    # ------------------------------------------------------------- queue ----

    def submit(self, request: Request) -> int:
        if self._draining:
            raise DrainingError("the engine is draining (a handoff is in "
                                "progress): submit to a peer instance")
        if self.cfg.family == "conv":
            expect = (self.cfg.image_size, self.cfg.image_size,
                      self.cfg.in_channels)
            img = None if request.image is None \
                else np.asarray(request.image, np.float32)
            if img is None or img.shape != expect:
                raise ValueError(
                    f"conv-family request needs image of shape {expect}, "
                    f"got {None if img is None else img.shape}")
            request.image = img
            request.max_new_tokens = 1     # one class id per image
            prompt_len = 0
        else:
            if len(request.prompt) < 1:
                raise ValueError("empty prompt: there is no position to "
                                 "sample the first token from")
            self._bucket(len(request.prompt))  # reject overlong now
            prompt_len = len(request.prompt)
        request.rid = self._next_rid
        self._next_rid += 1
        self._results[request.rid] = Result(
            rid=request.rid, prompt_len=prompt_len, tokens=[],
            t_submit=time.perf_counter(), t_first=0.0, t_done=0.0)
        self._queue.append(request)
        return request.rid

    # --------------------------------------------------------- admission ----

    def _prefill(self, prompt, rid: int):
        """``prefill_prompt`` at the prompt's bucket: (first token; the
        prefilled sub-state; the draft's, or None without a draft)."""
        bucket = self._bucket(len(prompt))
        self._buckets_used.add(bucket)
        return prefill_prompt(
            self.params, self.cfg, prompt, rid, bucket=bucket,
            capacity=self.capacity, seed=self.seed,
            temperature=self.temperature, top_k=self.top_k,
            draft=None if self.draft_cfg is None
            else (self.draft_params, self.draft_cfg))

    def _admit(self, req: Request, slot: int) -> bool:
        """Prefill ``req`` into ``slot``.  Returns False (the request is
        NOT consumed) only in block mode, when the pool cannot host the
        row yet: the caller defers it."""
        prompt = np.asarray(req.prompt, np.int64)
        if self.block_mgr is not None:
            tok = self._admit_blocked(prompt, req.rid, slot)
            if tok is None:
                return False
        else:
            first, sub, dsub = self._prefill(prompt, req.rid)
            self.state = models.write_slots(self.state, sub, [slot])
            if dsub is not None:
                self.draft_state = models.write_slots(self.draft_state, dsub,
                                                      [slot])
            tok = int(first[0])
        self.last_tok[slot, 0] = tok
        self.slot_rids[slot] = req.rid
        self._active[slot] = req
        res = self._results[req.rid]
        res.tokens.append(tok)
        res.t_first = time.perf_counter()
        return True

    def _admit_blocked(self, prompt, rid: int, slot: int) -> Optional[int]:
        """Block-pool admission: place the row's table, then either skip
        the forward (exact-prompt hit: shared blocks + COW tail clone +
        the cached first token) or prefill and scatter into the row's
        blocks.  Returns the first token, or None to defer."""
        adm = self.block_mgr.admit(prompt, self.n_k)
        if adm is None:
            return None                   # pool exhausted: defer
        self.table[slot] = torch.as_tensor(adm.table, dtype=torch.int32)
        self._slot_adm[slot] = adm
        if adm.first_token is not None:
            for dst, src in adm.cow:      # tail clone: the row WILL write
                blk.copy_block(self.state, dst, src)
            self.state.pos[slot] = len(prompt)
            return adm.first_token
        first, sub, _ = self._prefill(prompt, rid)
        blk.write_prefill(self.state, sub, adm.table, slot, self.block_size)
        if adm.snapshot is not None:
            # snapshot the tail block NOW, before any decode write dirties
            # it: later exact-prompt admissions clone from this copy
            blk.copy_block(self.state, adm.snapshot,
                           adm.table[len(prompt) // self.block_size])
        tok = int(first[0])
        self.block_mgr.finish(adm, tok)
        return tok

    def _admit_images(self, reqs: List[Request], slots: List[int]) -> None:
        """ONE forward classifies every freshly admitted image (rows
        zero-padded up to a power-of-two bucket), then the class ids land
        in the rows' results."""
        bucket = 1
        while bucket < len(reqs):
            bucket *= 2
        self._buckets_used.add(("img", bucket))
        cfg = self.cfg
        imgs = np.zeros((bucket, cfg.image_size, cfg.image_size,
                         cfg.in_channels), np.float32)
        for i, req in enumerate(reqs):
            imgs[i] = req.image
        # float inputs follow the params' dtype (bf16 under the bf16
        # preset, so the conv and LRN run their bf16 kernels)
        logits = self.params(torch.from_numpy(imgs).to(
            self.device, numerics.param_dtype(cfg)))
        toks = sampling.sample(logits, self.temperature, self.top_k,
                               self.generator)
        host = toks.cpu().numpy()      # the device sync point of the wave
        now = time.perf_counter()
        for i, (slot, req) in enumerate(zip(slots, reqs)):
            self._active[slot] = req
            res = self._results[req.rid]
            res.tokens.append(int(host[i]))
            res.t_first = now

    def _retire(self, slot: int, now: float) -> Result:
        req = self._active[slot]
        self._active[slot] = None
        if self.block_mgr is not None:
            self.block_mgr.release(self._slot_adm[slot])
            self._slot_adm[slot] = None
            # point the dead row at the trash block: its garbage decode
            # writes land where no live table looks
            self.table[slot] = 0
        # hand the Result to the caller and forget it
        res = self._results.pop(req.rid)
        res.t_done = now
        return res

    def _hit_limits(self, req: Request) -> bool:
        """True if the row must not consume another decode tick: its
        budget is met, or its ring is full (position prompt_len +
        len(tokens) - 1 == capacity - 1 is the last the cache holds)."""
        res = self._results[req.rid]
        return (len(res.tokens) >= req.max_new_tokens or
                res.prompt_len + len(res.tokens) - 1 >= self.capacity)

    # -------------------------------------------------------------- load ----

    @property
    def free_slots(self) -> int:
        return sum(r is None for r in self._active)

    @property
    def queue_len(self) -> int:
        return len(self._queue)

    def load(self) -> dict:
        """Slots free now, requests queued behind them, and whether the
        engine still admits."""
        return {"free_slots": self.free_slots, "queue_len": self.queue_len,
                "active": self.slots - self.free_slots,
                "draining": self._draining}

    # ---------------------------------------------------------- handoff ----

    def export_slot(self, slot: int) -> dict:
        """Snapshot live ``slot`` for a handoff: the row's DecodeState
        slice (``models.read_slots``), its last sampled token and its
        sampling rid (``slot_key``), copied to the host once, and the
        request's bookkeeping.  ``import_snapshot`` into any free slot of
        a same-shape engine continues the stream token for token:
        sampling is positional on (seed, sampling rid, position), and the
        retire rule reads (prompt_len, tokens, capacity), never the slot
        index or the peers' traffic."""
        req = self._active[slot]
        if req is None:
            raise ValueError(f"slot {slot} is not active")
        res = self._results[req.rid]
        with torch.inference_mode():
            sub = models.read_slots(self.state, [slot])
            arrays = tree_map(lambda t: t.cpu(), {
                "cache": sub.cache, "pos": sub.pos,
                "last_tok": self.last_tok[slot:slot + 1],
                "slot_key": self.slot_rids[slot]})
        return {
            "arrays": arrays,
            "meta": {
                "rid": int(req.rid),       # engine-local: the router maps it
                "prompt": np.asarray(req.prompt, np.int64).tolist(),
                "max_new_tokens": int(req.max_new_tokens),
                "prompt_len": res.prompt_len,
                "tokens": list(res.tokens),
                "t_submit": res.t_submit, "t_first": res.t_first,
                "draft_proposed": res.draft_proposed,
                "draft_accepted": res.draft_accepted,
            },
        }

    def import_snapshot(self, snap: dict) -> Optional[int]:
        """Replay an ``export_slot`` (or prefill worker) snapshot into the
        first free slot.  Returns the request's new engine-local rid, or
        None when no slot is free (the caller retries after a step).  The
        row samples on with the snapshot's sampling rid, not the new
        one, so a sampled stream goes on as it would have."""
        slot = next((s for s, r in enumerate(self._active) if r is None),
                    None)
        if slot is None:
            return None
        arrays, meta = snap["arrays"], snap["meta"]
        with torch.inference_mode():
            sub = models.DecodeState(
                cache=tree_map(lambda t: t.to(self.device), arrays["cache"]),
                pos=arrays["pos"].to(self.device))
            self.state = models.write_slots(self.state, sub, [slot])
            self.last_tok[slot] = arrays["last_tok"][0].to(self.device)
            self.slot_rids[slot] = int(arrays["slot_key"])
        req = Request(prompt=np.asarray(meta["prompt"], np.int64),
                      max_new_tokens=meta["max_new_tokens"],
                      rid=self._next_rid)
        self._next_rid += 1
        self._active[slot] = req
        self._results[req.rid] = Result(
            rid=req.rid, prompt_len=meta["prompt_len"],
            tokens=list(meta["tokens"]), t_submit=meta["t_submit"],
            t_first=meta["t_first"], t_done=0.0,
            draft_proposed=meta["draft_proposed"],
            draft_accepted=meta["draft_accepted"])
        return req.rid

    def drain(self) -> tuple:
        """Stop admitting, snapshot every live row, hand back the queue:
        (snapshots, queued requests).  The engine is empty afterwards and
        ``submit`` raises ``DrainingError``; the router replays the
        snapshots into peers, so no request is dropped."""
        if self.block_mgr is not None:
            raise NotImplementedError(
                "drain: block-pool tables index a process-local pool; "
                "export and replay need the ring layout")
        if self.draft_cfg is not None:
            raise NotImplementedError(
                "drain: a spec engine would need the draft's DecodeState "
                "exported beside the target's")
        self._draining = True
        snaps = [self.export_slot(s) for s, r in enumerate(self._active)
                 if r is not None]
        queued = list(self._queue)
        self._queue.clear()
        self._active = [None] * self.slots
        self._results.clear()              # queued rows held Results too
        return snaps, queued

    # -------------------------------------------------------------- step ----

    def _decode(self):
        """One dispatch: ``ticks`` decode ticks with the sampled tokens
        kept on the device.  Returns the packed (2, slots, K) block of
        tokens and eos flags, still on the device."""
        toks, seq = self.last_tok, []
        for _ in range(self.ticks):
            logits, self.state = models.decode_step(
                self.params, self.cfg, self.state, toks, table=self.table)
            tok = sampling.sample_slots(self.seed, self.slot_rids,
                                        self.state.pos, logits[:, 0],
                                        self.temperature, self.top_k)
            seq.append(tok)
            toks = tok[:, None]
        self.last_tok = toks
        block = torch.stack(seq, dim=1)                 # (slots, K)
        flags = (torch.zeros_like(block) if self.eos_id is None
                 else (block == self.eos_id).long())
        return torch.stack([block, flags])

    def step(self) -> List[Result]:
        """Retire finished rows and admit what fits (repeating until the
        admission fixpoint), then (LM) run ONE decode dispatch.  Returns
        the requests finished on this step."""
        with torch.inference_mode():
            return self._step()

    def _step(self) -> List[Result]:
        finished = []
        while True:
            now = time.perf_counter()
            for slot, req in enumerate(self._active):
                if req is not None and self._hit_limits(req):
                    finished.append(self._retire(slot, now))
            admitted = False
            batch = []                 # the conv family admits as ONE batch
            for slot in range(self.slots):
                if self._active[slot] is None and self._queue:
                    req = self._queue.popleft()
                    if self.cfg.family == "conv":
                        batch.append((slot, req))
                        admitted = True
                    elif self._admit(req, slot):
                        admitted = True
                    else:
                        # block pool exhausted: requeue at the FRONT and
                        # stop admitting; retirements free blocks later
                        self._queue.appendleft(req)
                        break
            if batch:
                self._admit_images([r for _, r in batch],
                                   [s for s, _ in batch])
            if not admitted:
                break
        if not any(self._active) and not self._queue:
            return finished
        if not any(self._active):
            # block mode deferred the queue head with an otherwise idle
            # engine: the pool is as free as it gets, so waiting cannot help
            raise RuntimeError(
                f"block pool ({self.block_mgr.nb} x {self.block_size}) "
                f"cannot host one request of {self.n_k} blocks")
        if self.draft_cfg is not None:
            self._spec_dispatch(finished)
            return finished
        host = _to_host(self._decode())    # the one read per dispatch
        self.decode_steps += self.ticks
        self.dispatches += 1
        block, flags = host[0], host[1]
        now = time.perf_counter()
        for j in range(self.ticks):
            for slot, req in enumerate(self._active):
                if req is None:
                    continue               # retired at an earlier tick
                res = self._results[req.rid]
                res.tokens.append(int(block[slot, j]))
                if self._hit_limits(req) or flags[slot, j]:
                    finished.append(self._retire(slot, now))
        return finished

    def _spec_dispatch(self, finished: List[Result]) -> None:
        """One speculative round (``spec_decode.spec_round``); then, per
        row, its emitted tokens under the same retirement rules as a
        plain tick's, the accept counts read from the one packed block."""
        packed, self.last_tok, self.state, self.draft_state = \
            spec_decode.spec_round(self.params, self.cfg, self.draft_params,
                                   self.draft_cfg, self.state,
                                   self.draft_state, self.last_tok,
                                   self.spec_tokens, self.eos_id)
        host = _to_host(packed)            # the one read per dispatch
        self.decode_steps += 1             # one target pass per dispatch
        self.dispatches += 1
        g1 = self.spec_tokens + 1
        emit, flags, acc = host[:, :g1], host[:, g1:2 * g1], host[:, -1]
        now = time.perf_counter()
        for slot, req in enumerate(self._active):
            if req is None:
                continue
            res = self._results[req.rid]
            a = int(acc[slot])
            res.draft_proposed += self.spec_tokens
            res.draft_accepted += a - 1
            self.spec_proposed += self.spec_tokens
            self.spec_accepted += a - 1
            for j in range(a):
                res.tokens.append(int(emit[slot, j]))
                if self._hit_limits(req) or flags[slot, j]:
                    finished.append(self._retire(slot, now))
                    break

    def run(self, requests=None) -> List[Result]:
        """Submit ``requests`` (if given) and step until everything is
        done.  Returns results in completion order."""
        for r in requests or ():
            self.submit(r)
        out = []
        while self._queue or any(r is not None for r in self._active):
            out.extend(self.step())
        return out
