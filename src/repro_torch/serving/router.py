"""Request router of the multi-process serving tier (the counterpart of
``repro/serving/router.py``).

The router is the tier's one front door: it owns the global request
ids, spreads admissions over N engine instances, gathers finished
results and per-instance stats, and runs the tier's two manoeuvres:
disaggregated prefill (the prefill worker builds a snapshot, a decode
instance injects it) and drain (a draining instance's live rows are
replayed into its peers).

Placement is least-loaded: instances are ranked by (most free slots,
shortest queue) on fresh stats at each placement, so a burst spreads
instead of piling onto one instance.  Backpressure is deferred
admission: a worker with no free slot and a full queue answers
``defer``, and the router puts the request back AT THE FRONT (FIFO order
holds) and retries on a later ``pump``; nothing is dropped.  In a
disaggregated tier a deferred prompt is prefilled again at its retry.

Failure: a transport error marks the instance dead, and every request
placed on it restarts from its prompt on a peer (at-least-once: the
tokens the dead instance had made are made again).  ``drain_instance``
is the graceful version: its live rows move mid-stream with no request
dropped and the same tokens, because sampling is positional and the
retire rule depends only on (prompt_len, tokens, capacity), never on
the slot or the process.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

from repro_torch import checkpoint
from repro_torch.serving import tier as tier_mod
from repro_torch.serving.engine import Request
from repro_torch.serving.tier import InstanceHandle


class DeadInstanceError(RuntimeError):
    """A request exhausted its placement retries on dying instances."""


class Router:
    def __init__(self, instances: List[InstanceHandle], *,
                 prefill: Optional[InstanceHandle] = None,
                 max_retries: int = 2):
        if not instances:
            raise ValueError("a router needs at least one engine instance")
        self.instances = list(instances)
        self.prefill_worker = prefill       # disaggregated mode when set
        self.max_retries = max_retries
        self._next_rid = 0
        # grid = router-global request id; instances keep their own rids
        self._pending: collections.deque = collections.deque()   # (grid, wire)
        self._pending_inject: collections.deque = collections.deque()
        self._placed: Dict[int, tuple] = {}      # grid -> (handle, local_rid)
        self._wire: Dict[int, dict] = {}         # grid -> wire request
        self._results: Dict[int, dict] = {}      # grid -> wire result
        self._t_submit: Dict[int, float] = {}
        self._t_done: Dict[int, float] = {}
        self._retries: collections.Counter = collections.Counter()
        self.deferred = 0                        # backpressure events seen
        self.step_times: Dict[str, List[float]] = \
            collections.defaultdict(list)

    # ------------------------------------------------------------ submit ----

    def submit(self, req) -> int:
        """Route one request (a ``serving.Request`` or its wire dict);
        returns the router-global request id."""
        wire = tier_mod.request_to_wire(req) if isinstance(req, Request) \
            else dict(req)
        grid = self._next_rid
        self._next_rid += 1
        wire["rid"] = grid                   # the tier-wide identity
        self._wire[grid] = wire
        self._t_submit[grid] = time.perf_counter()
        self._pending.append((grid, wire))
        self.pump()
        return grid

    def _alive(self) -> List[InstanceHandle]:
        return [i for i in self.instances if not i.dead]

    def _ranked(self) -> List[tuple]:
        """Alive, non-draining instances by (most free slots, shortest
        queue) — fresh stats, dead peers culled as a side effect."""
        ranked = []
        for inst in self._alive():
            try:
                _, st = inst.call("stats")
            except ConnectionError:
                self._on_death(inst)
                continue
            self.step_times[inst.name].extend(st.get("step_times", ()))
            if not st["draining"]:
                ranked.append((-st["free_slots"], st["queue_len"], st, inst))
        ranked.sort(key=lambda t: t[:2])
        return [(st, inst) for _, _, st, inst in ranked]

    def _place(self, grid: int, wire: dict) -> bool:
        if self.prefill_worker is not None:
            return self._place_disagg(grid, wire)
        for st, inst in self._ranked():
            try:
                status, rid = inst.call("submit", wire)
            except ConnectionError:
                self._on_death(inst)
                continue
            if status == "ok":
                self._placed[grid] = (inst, rid)
                return True
            self.deferred += 1               # defer / draining: next peer
        return False

    def _place_disagg(self, grid: int, wire: dict) -> bool:
        """Disaggregated path: the prefill worker builds the snapshot, a
        decode instance injects it, and the decode tick loop never runs a
        prefill.  A snapshot no instance takes is dropped: the prompt
        stays pending and is prefilled again at its retry."""
        try:
            _, buf = self.prefill_worker.call("prefill", wire)
        except ConnectionError:
            # no prefill worker, no disagg: fall back to colocated path
            self.prefill_worker = None
            return self._place(grid, wire)
        return self._inject(grid, buf)

    def _inject(self, grid: int, buf: bytes) -> bool:
        for st, inst in self._ranked():
            if st["free_slots"] == 0:
                continue
            try:
                status, rid = inst.call("inject", buf)
            except ConnectionError:
                self._on_death(inst)
                continue
            if status == "ok" and rid is not None:
                self._placed[grid] = (inst, rid)
                return True
            self.deferred += 1
        return False

    # -------------------------------------------------------------- pump ----

    def pump(self):
        """One router turn: collect finished results, then retry every
        deferred placement/injection (front of the queue first)."""
        for inst in self._alive():
            try:
                _, results = inst.call("poll")
            except ConnectionError:
                self._on_death(inst)
                continue
            by_rid = {rid: g for g, (h, rid) in self._placed.items()
                      if h is inst}
            for res in results:
                grid = by_rid.get(res["rid"])
                if grid is None:
                    continue                 # finished under an old identity
                self._results[grid] = res
                self._t_done[grid] = time.perf_counter()
                del self._placed[grid]
        for queue, place in ((self._pending, self._place),
                             (self._pending_inject, self._inject)):
            for _ in range(len(queue)):
                grid, payload = queue.popleft()
                if grid in self._results:
                    continue                 # completed before the retry
                if not place(grid, payload):
                    queue.appendleft((grid, payload))
                    break                    # FIFO: nothing jumps the head

    def _on_death(self, inst: InstanceHandle):
        """Mark ``inst`` dead and re-place everything it held: requests
        restart from their prompt on a peer (at-least-once; the dead
        instance's partial tokens are regenerated)."""
        if inst.dead:
            return
        inst.dead = True
        inst.close(timeout=1.0)
        for grid in [g for g, (h, _) in self._placed.items() if h is inst]:
            del self._placed[grid]
            self._retries[grid] += 1
            if self._retries[grid] > self.max_retries:
                raise DeadInstanceError(
                    f"request {grid} lost {self._retries[grid]} instances "
                    f"(max_retries={self.max_retries})")
            self._pending.appendleft((grid, self._wire[grid]))

    # ------------------------------------------------------------- drain ----

    def drain_instance(self, inst: InstanceHandle, *,
                       timeout: float = 60.0) -> tuple:
        """Elastic drain: snapshot ``inst``'s live slots and queue, then
        replay every snapshot into a peer (mid-stream, byte-identical)
        and re-route the queued requests.  ``inst`` afterwards admits
        nothing (``DrainingError`` on submit) and can be shut down.
        Returns (live rows replayed, queued requests placed again)."""
        _, (snaps, queued) = inst.call("drain")
        by_rid = {rid: g for g, (h, rid) in self._placed.items()
                  if h is inst}
        for buf in snaps:
            grid = by_rid.get(checkpoint.peek_meta(buf)["rid"])
            if grid is None:
                continue
            del self._placed[grid]
            self._pending_inject.append((grid, buf))
        for wire in queued:
            grid = by_rid.get(wire["rid"])
            if grid is None:
                continue
            del self._placed[grid]
            self._pending.appendleft((grid, self._wire[grid]))
        deadline = time.monotonic() + timeout
        while self._pending_inject:
            self.pump()
            if not self._pending_inject:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"drain handoff: {len(self._pending_inject)} snapshots "
                    f"still homeless after {timeout:.0f}s")
            time.sleep(0.01)
        return len(snaps), len(queued)

    # ----------------------------------------------------------- results ----

    def outstanding(self) -> int:
        return len(self._wire) - len(self._results)

    def run_until_done(self, *, timeout: float = 600.0) -> List[dict]:
        """Pump until every submitted request finished; results ordered
        by global rid, each annotated with router-clock latency/ttft."""
        deadline = time.monotonic() + timeout
        while self.outstanding():
            self.pump()
            if self.outstanding() and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{self.outstanding()} requests unfinished after "
                    f"{timeout:.0f}s (pending={len(self._pending)}, "
                    f"placed={len(self._placed)})")
            if self.outstanding():
                time.sleep(0.002)
        out = []
        for grid in sorted(self._results):
            res = dict(self._results[grid])
            res["grid"] = grid
            res["router_latency"] = self._t_done[grid] - self._t_submit[grid]
            out.append(res)
        return out

    def stats(self) -> dict:
        """Aggregated tier load + per-instance step-time samples."""
        per = {}
        for inst in self._alive():
            try:
                _, st = inst.call("stats")
            except ConnectionError:
                self._on_death(inst)
                continue
            self.step_times[inst.name].extend(st.pop("step_times", ()))
            per[inst.name] = st
        return {"instances": per, "deferred": self.deferred,
                "dead": [i.name for i in self.instances if i.dead],
                "outstanding": self.outstanding()}

    def shutdown(self):
        """Ask every worker to stop, then wait for each (so they wind
        down at once, not one after another)."""
        workers = self.instances + ([self.prefill_worker]
                                    if self.prefill_worker else [])
        for inst in workers:
            inst.stop()
        for inst in workers:
            inst.close()
