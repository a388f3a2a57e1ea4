"""Slot-based serving engine for image classification (the conv family).

The counterpart of ``repro/serving/engine.py`` for ``family == "conv"``:
each request is one raw (image_size, image_size, in_channels) image and
its result is one class id.  The engine keeps ``slots`` rows and runs
the reference's admission fixpoint:

  retire   rows whose token budget is met (every conv row, one token)
           free their slot and hand back their ``Result``;
  admit    queued requests fill the free slots, and the freshly admitted
           images are classified by ONE batched forward, zero-padded up to
           a power-of-two bucket;

repeated until nothing more is admitted, so a wave's slots are refilled
within the same ``step``.  Classification never decodes:
``decode_steps`` stays 0.  The LM families, multi-tick decode, spec
decode, the block pool and the replica mesh are not ported yet (ROADMAP
queue A); other families raise.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.serving import sampling


@dataclasses.dataclass
class Request:
    """One request.  For the conv family ``image`` IS the request (an
    (image_size, image_size, in_channels) array); the prompt is ignored
    and the result is one class id."""
    prompt: Any = ()
    max_new_tokens: int = 32
    image: Any = None
    rid: int = -1                      # assigned by submit()


@dataclasses.dataclass
class Result:
    rid: int
    prompt_len: int
    tokens: List[int]                  # generated ids (the class id)
    t_submit: float
    t_first: float                     # first token emitted
    t_done: float

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_submit

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit


class ServingEngine:
    """Serves ``model`` (an ``nn.Module`` taking NHWC images) for ``cfg``
    on the model's device."""

    def __init__(self, model, cfg, *, slots: int = 4,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0):
        if cfg.family != "conv":
            raise NotImplementedError(
                f"the port's ServingEngine serves the conv family only; "
                f"{cfg.name} is {cfg.family!r} (the LM families come with "
                "the LM serving slice, ROADMAP queue A)")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.model, self.cfg, self.slots = model, cfg, slots
        self.temperature, self.top_k = temperature, top_k
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._active: List[Optional[Request]] = [None] * slots
        self._results: Dict[int, Result] = {}
        self._queue: collections.deque = collections.deque()
        self._next_rid = 0
        self._buckets_used: set = set()    # ("img", bucket) batch shapes
        self.decode_steps = 0          # model ticks run (never, for conv)

    # ------------------------------------------------------------- queue ----

    def submit(self, request: Request) -> int:
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
        request.rid = self._next_rid
        self._next_rid += 1
        self._results[request.rid] = Result(
            rid=request.rid, prompt_len=0, tokens=[],
            t_submit=time.perf_counter(), t_first=0.0, t_done=0.0)
        self._queue.append(request)
        return request.rid

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
        with torch.inference_mode():
            logits = self.model(torch.from_numpy(imgs).to(self.device))
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
        # hand the Result to the caller and forget it
        res = self._results.pop(req.rid)
        res.t_done = now
        return res

    def _hit_limits(self, req: Request) -> bool:
        return len(self._results[req.rid].tokens) >= req.max_new_tokens

    # -------------------------------------------------------------- load ----

    @property
    def free_slots(self) -> int:
        return sum(r is None for r in self._active)

    @property
    def queue_len(self) -> int:
        return len(self._queue)

    def load(self) -> dict:
        """Slots free now, requests queued behind them."""
        return {"free_slots": self.free_slots, "queue_len": self.queue_len,
                "active": self.slots - self.free_slots}

    # -------------------------------------------------------------- step ----

    def step(self) -> List[Result]:
        """Retire finished rows and admit what fits, repeating until the
        admission fixpoint.  Returns the requests finished on this step."""
        finished = []
        while True:
            now = time.perf_counter()
            for slot, req in enumerate(self._active):
                if req is not None and self._hit_limits(req):
                    finished.append(self._retire(slot, now))
            batch = []
            for slot in range(self.slots):
                if self._active[slot] is None and self._queue:
                    batch.append((slot, self._queue.popleft()))
            if not batch:
                return finished
            self._admit_images([r for _, r in batch], [s for s, _ in batch])

    def run(self, requests=None) -> List[Result]:
        """Submit ``requests`` (if given) and step until everything is
        done.  Returns results in completion order."""
        for r in requests or ():
            self.submit(r)
        out = []
        while self._queue or any(r is not None for r in self._active):
            out.extend(self.step())
        return out
