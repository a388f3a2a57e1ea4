"""Parallel data loading, the paper's §2.1 / Fig. 1 (the counterpart of
``repro/data/pipeline.py``).

The paper runs a separate loading process that copies the next minibatch
host -> GPU while the training process computes.  Here a background
thread does it (numpy preprocessing releases the interpreter lock):

    loader thread:   fetch -> preprocess -> stage on the device -> queue
    trainer thread:  queue -> step(current)                 (overlapped)

``PrefetchLoader`` is a depth-``prefetch`` handoff queue (``prefetch=0``
is the serial baseline, the paper's "Parallel loading: No").

``StagedPinnedLoader`` is Fig. 1 taken literally: the worker stages each
batch into one of a rotating set of preallocated pinned host buffers and
copies it with ``non_blocking`` copies on a side CUDA stream into that
slot's preallocated device buffers.  The trainer's stream waits for the
copy through an event.  A slot is reused only after the step that read
it has finished: after dispatching that step the trainer calls
``loader.fence()``, which records a CUDA event on the current stream,
and the worker waits on it (off the critical path) before overwriting the
slot.  Pinned staging needs a CUDA device; on any other it raises.

Both loaders report stalls: ``last_wait_ms`` is the time the trainer
blocked in ``next()`` for the latest batch (the session logs it per
step as ``stage_wait_ms``).
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.kernels.common import device_of
from repro_torch.tree import tree_leaves, tree_map


def to_device(device):
    """A ``device_put`` for host batches of numpy arrays."""
    dev = torch.device(device)
    return lambda batch: tree_map(lambda x: torch.from_numpy(
        np.ascontiguousarray(x)).to(dev), batch)


class _ExcBox:
    def __init__(self, exc):
        self.exc = exc


_SENTINEL = object()
_CLOSED = object()


class _Worker:
    """The thread, queue and stop flag both loaders share."""

    def __init__(self, depth: int):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._done = False             # sentinel seen: stay exhausted
        self.last_wait_ms = 0.0

    def _start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            self._work()
            self._put(_SENTINEL)
        except Exception as e:                      # surface in consumer
            self._put(_ExcBox(e))

    def _put(self, item) -> bool:
        """Enqueue unless stopped; never blocks past ``close()``."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _get(self, name: str, stalled: Callable[[], bool]):
        """The next item, raising if closed, stalled or the worker died."""
        if self._stop.is_set():
            raise RuntimeError(f"{name} is closed")
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():
                    raise RuntimeError(f"{name} is closed") from None
                if stalled():
                    raise RuntimeError(
                        "all staging slots await fences: call "
                        "loader.fence() after each consumed batch") from None
                t = self._thread
                if t is not None and not t.is_alive() and self._q.empty():
                    raise RuntimeError(f"{name} worker exited") from None
        if item is _SENTINEL:
            self._done = True
            raise StopIteration
        if isinstance(item, _ExcBox):
            raise item.exc
        self.last_wait_ms = (time.perf_counter() - t0) * 1e3
        return item

    def __iter__(self):
        return self

    def close(self):
        """Stop and join the worker thread."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class PrefetchLoader(_Worker):
    """Wraps a host-batch iterator with background staging.

    Args:
      source: iterator of trees of numpy arrays.
      prefetch: queue depth (2 = double buffer; 0 = synchronous).
      preprocess: host-side transform run in the loader thread.
      device_put: stages a host tree; defaults to tensors on the entry
        point's device (``device_of(None)``: CUDA, which raises where it
        is absent), as the reference's defaults to ``jax.device_put``.
    """

    def __init__(self, source: Iterator, prefetch: int = 2,
                 preprocess: Optional[Callable] = None,
                 device_put: Optional[Callable] = None):
        super().__init__(prefetch)
        self._source = iter(source)
        self._prefetch = prefetch
        self._preprocess = preprocess or (lambda x: x)
        self._device_put = device_put or to_device(device_of(None))
        if prefetch > 0:
            self._start()

    def _work(self):
        for batch in self._source:
            if self._stop.is_set():
                return
            if not self._put(self._device_put(self._preprocess(batch))):
                return

    def __next__(self):
        if self._prefetch == 0:
            if self._stop.is_set():
                raise RuntimeError("PrefetchLoader is closed")
            t0 = time.perf_counter()
            out = self._device_put(self._preprocess(next(self._source)))
            self.last_wait_ms = (time.perf_counter() - t0) * 1e3
            return out
        return self._get("PrefetchLoader", lambda: False)

    def fence(self):
        """No-op: the queue never reuses a buffer.  Present so the
        training loop treats both loaders alike."""


class StagedPinnedLoader(_Worker):
    """Staging through ``slots`` preallocated pinned host buffers and
    device buffers, reused under CUDA-event fences (module docstring).

        batch = next(loader)        # staged; the stream waits for its copy
        state, loss = step(state, batch)
        loader.fence()              # after dispatching the step
    """

    def __init__(self, source: Iterator, *, device,
                 preprocess: Optional[Callable] = None, slots: int = 2):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"pinned staging copies to a CUDA device, got "
                             f"{dev}; use staging='queue'")
        if slots < 2:
            raise ValueError(f"need at least a double buffer, got {slots}")
        super().__init__(slots)
        self._source = iter(source)
        self._preprocess = preprocess or (lambda x: x)
        self._device = dev
        self._slots = slots
        self._bufs = [None] * slots          # (pinned host, device) trees
        # per-slot fence events; a pre-seeded None means the slot is free
        self._free = [queue.Queue(maxsize=1) for _ in range(slots)]
        for fq in self._free:
            fq.put(None)
        self._handout: collections.deque = collections.deque()
        self._start()

    def _take_fence(self, s: int):
        while not self._stop.is_set():
            try:
                return self._free[s].get(timeout=0.05)
            except queue.Empty:
                continue
        return _CLOSED

    def _buffers(self, s: int, host, stream):
        """Slot ``s``'s buffers, (re)allocated when the batch's shapes
        differ from the last lap's (first lap, a ragged final batch).
        The device buffers are allocated on the side ``stream`` that
        writes them: the caching allocator then hands out only memory
        whose last use was on that stream, never a block just freed on
        the trainer's stream while a kernel queued there still uses it."""
        leaves = tree_leaves(host)
        bufs = self._bufs[s]
        if bufs is None or any(
                tuple(p.shape) != x.shape or p.numpy().dtype != x.dtype
                for p, x in zip(tree_leaves(bufs[0]), leaves)):
            pinned = tree_map(lambda x: torch.from_numpy(
                np.empty(x.shape, x.dtype)).pin_memory(), host)
            with torch.cuda.stream(stream):
                dev = tree_map(lambda p: torch.empty_like(
                    p, device=self._device), pinned)
            bufs = self._bufs[s] = (pinned, dev)
        return bufs

    def _work(self):
        stream = torch.cuda.Stream(device=self._device)
        s = 0
        for batch in self._source:
            if self._stop.is_set():
                return
            host = self._preprocess(batch)
            ev = self._take_fence(s)
            if ev is _CLOSED:
                return
            if ev is not None:
                ev.synchronize()         # the step that read slot s is done
            pinned, dev = self._buffers(s, host, stream)
            tree_map(lambda p, x: np.copyto(p.numpy(), x), pinned, host)
            with torch.cuda.stream(stream):
                for d, p in zip(tree_leaves(dev), tree_leaves(pinned)):
                    d.copy_(p, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(stream)
            if not self._put((s, dev, ready)):
                return
            s = (s + 1) % self._slots

    def __next__(self):
        slot, dev, ready = self._get(
            "StagedPinnedLoader",
            lambda: len(self._handout) >= self._slots)
        current = torch.cuda.current_stream(self._device)
        current.wait_event(ready)
        for d in tree_leaves(dev):
            d.record_stream(current)   # freed only after the step's use
        self._handout.append(slot)
        return dev

    def fence(self):
        """Mark the oldest un-fenced batch's slot reusable once the work
        queued so far on the current stream (the step that read it) is
        done."""
        if self._handout:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self._device))
            self._free[self._handout.popleft()].put(ev)


def make_loader(source: Iterator, *, prefetch: int = 2,
                staging: str = "queue", preprocess: Optional[Callable] = None,
                device_put: Optional[Callable] = None, device=None):
    """The loader the session uses: ``queue`` is the depth-``prefetch``
    handoff queue onto ``device_put``; ``pinned`` is the fenced pinned
    path onto ``device`` (needs ``fence()`` after every step)."""
    if staging == "pinned":
        return StagedPinnedLoader(source, device=device,
                                  preprocess=preprocess,
                                  slots=max(prefetch, 2))
    if staging != "queue":
        raise ValueError(f"staging must be 'queue' or 'pinned', "
                         f"got {staging!r}")
    return PrefetchLoader(source, prefetch=prefetch, preprocess=preprocess,
                          device_put=device_put)
