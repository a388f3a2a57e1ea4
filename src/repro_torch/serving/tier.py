"""The multi-process serving tier: worker processes and their wire
protocol (the counterpart of ``repro/serving/tier.py``).

A tier is N engine instances, each a separate OS process that owns its
own ``ServingEngine`` on the one card, fronted by a
``serving.router.Router`` in the process that started them.  Instances
never talk to each other, only to the router, over
``multiprocessing.connection`` sockets (pickles on localhost TCP with an
authkey handshake).  Workers
are fresh interpreters (``spawn_worker`` starts ``python -m
repro_torch.launch.serve --role ...``): nothing forks a process that has
initialised CUDA.

Two kinds of worker share ``worker_serve``:

  engine / decode   owns slots and steps on its own whenever it has live
                    or queued work, answering RPCs between steps.
                    ``decode`` names an instance of a disaggregated tier,
                    which only admits prefilled snapshots (``inject``);
                    its code is the engine's.
  prefill           owns no slots: runs the engine's bucketed prefill on
                    each submitted prompt and answers with an inject-ready
                    snapshot (``PrefillWorker``), so long prompts take
                    this process's time, not a decode instance's ticks.

State crosses processes as ``checkpoint.pack_tree`` buffers: one
request's DecodeState row (``ServingEngine.export_slot`` /
``PrefillWorker.prefill``) packs to a self-describing blob that the
receiver unpacks against its own config's structure (``snapshot_like``),
every leaf bit for bit (bf16 and int8 caches included).

A snapshot's ``slot_key`` is the row's sampling rid (an int64): the
port's sampling is positional on (engine seed, sampling rid, position),
so a row that moves keeps its rid for sampling and a sampled stream goes
on unchanged.  (The reference carries a JAX PRNG key there.)

Engines stamp Results with ``time.perf_counter``, whose epoch is per
process: latencies across processes are the router's, on its clock.
"""
from __future__ import annotations

import os
import select
import subprocess
import sys
import time
from multiprocessing.connection import Client, Listener
from typing import List, Optional

import numpy as np
import torch

from repro_torch import checkpoint, models
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import Request
from repro_torch.tree import tree_map

AUTHKEY = b"repro-serving-tier"


class TierError(RuntimeError):
    """A worker answered an RPC with an application error."""


def kernel_launches() -> dict:
    """This process's launch counts of the serving kernels (a worker
    reports them in its stats, so the router's process can see which
    kernels its instances ran)."""
    from repro_torch.kernels.decode_attention.ops import (decode_ring,
                                                          decode_table)
    from repro_torch.kernels.flash_attention.ops import flash_fwd
    from repro_torch.kernels.rglru.ops import rglru_fwd
    from repro_torch.kernels.rwkv6.ops import wkv_fwd
    return {"flash_fwd": flash_fwd.launches,
            "decode_ring": decode_ring.launches,
            "decode_table": decode_table.launches,
            "wkv_fwd": wkv_fwd.launches, "rglru_fwd": rglru_fwd.launches}


# ------------------------------------------------------------------ wire ----

def request_to_wire(req: Request) -> dict:
    """A token request as a plain dict; image requests serve in one
    process (the snapshot carries the token path's DecodeState only)."""
    if req.image is not None:
        raise NotImplementedError(
            "the serving tier routes token requests only; image requests "
            "serve in one process")
    return {"prompt": np.asarray(req.prompt, np.int64).tolist(),
            "max_new_tokens": int(req.max_new_tokens), "rid": int(req.rid)}


def request_from_wire(d: dict) -> Request:
    return Request(prompt=np.asarray(d["prompt"], np.int64),
                   max_new_tokens=int(d["max_new_tokens"]))


def result_to_wire(res) -> dict:
    return {"rid": res.rid, "prompt_len": res.prompt_len,
            "tokens": list(res.tokens), "t_submit": res.t_submit,
            "t_first": res.t_first, "t_done": res.t_done,
            "draft_proposed": res.draft_proposed,
            "draft_accepted": res.draft_accepted}


# -------------------------------------------------------------- snapshots ----

def snapshot_like(cfg, capacity: int) -> dict:
    """The structure of a one-row slot snapshot, for ``unpack_snapshot``
    (the leaves' dtypes and shapes come from the buffer's manifest)."""
    return {"cache": models.init_decode_cache(cfg, 1, capacity,
                                              device="meta"),
            "pos": 0, "last_tok": 0, "slot_key": 0}


def pack_snapshot(snap: dict) -> bytes:
    return checkpoint.pack_tree(snap["arrays"], meta=snap["meta"])


def unpack_snapshot(buf: bytes, like) -> dict:
    arrays, meta = checkpoint.unpack_tree(buf, like)
    return {"arrays": arrays, "meta": meta}


# --------------------------------------------------------- prefill worker ----

class PrefillWorker:
    """Disaggregated prefill: the engine's bucketed prefill
    (``engine.prefill_prompt`` at ``engine.buckets_for(capacity)``) with
    no decode slots.  ``prefill`` turns one wire request into an
    inject-ready snapshot, which a decode instance admits through
    ``ServingEngine.import_snapshot`` without running a prefill itself.

    The first token is sampled with the wire's rid, and the snapshot
    carries it as the row's sampling rid; ``seed`` must be the decode
    instances' for the stream to go on as one engine would sample it."""

    def __init__(self, params, cfg, *, capacity: int,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0):
        if cfg.family == "conv":
            raise NotImplementedError(
                f"the prefill worker serves token requests; {cfg.name} "
                "classifies images in one process")
        self.params, self.cfg, self.capacity = params, cfg, capacity
        self.buckets = engine_mod.buckets_for(capacity)
        self.temperature, self.top_k, self.seed = temperature, top_k, seed
        self.prefills = 0

    def prefill(self, reqd: dict) -> dict:
        prompt = np.asarray(reqd["prompt"], np.int64)
        n = len(prompt)
        if n < 1:
            raise ValueError("empty prompt: there is no position to sample "
                             "the first token from")
        rid = int(reqd.get("rid", 0))
        with torch.inference_mode():
            first, sub, _ = engine_mod.prefill_prompt(
                self.params, self.cfg, prompt, rid,
                bucket=engine_mod.bucket_of(self.buckets, n),
                capacity=self.capacity, seed=self.seed,
                temperature=self.temperature, top_k=self.top_k)
            arrays = tree_map(lambda t: t.cpu(), {
                "cache": sub.cache, "pos": sub.pos,
                "last_tok": first[:, None],
                "slot_key": torch.tensor(rid, dtype=torch.long)})
        self.prefills += 1
        now = time.perf_counter()
        return {
            "arrays": arrays,
            "meta": {"prompt": prompt.tolist(),
                     "max_new_tokens": int(reqd["max_new_tokens"]),
                     "prompt_len": n,
                     "tokens": [int(arrays["last_tok"][0, 0])],
                     "t_submit": float(reqd.get("t_submit", now)),
                     "t_first": now, "rid": int(reqd.get("rid", -1)),
                     "draft_proposed": 0, "draft_accepted": 0},
        }


# ------------------------------------------------------------ worker loop ----

def worker_listener(port: int = 0, *, host: str = "127.0.0.1",
                    authkey: bytes = AUTHKEY) -> Listener:
    """A worker's socket, bound (port 0: any free port) before its model
    is built, so that no other process can take the port meanwhile."""
    return Listener((host, port), authkey=authkey)


def worker_serve(obj, port, *, host: str = "127.0.0.1",
                 authkey: bytes = AUTHKEY, max_queue: Optional[int] = None,
                 port_fd: Optional[int] = None):
    """Serve one ``ServingEngine`` or ``PrefillWorker`` to a single
    router connection until shutdown or disconnect.  ``port`` is a port
    number or a bound ``worker_listener``; with ``port_fd`` the bound
    port is written to that descriptor (the spawner's pipe) just before
    the worker accepts.

    An engine worker steps on its own: whenever rows are live or queued
    it runs ``engine.step()`` and banks the finished results for the
    next ``poll``; RPCs are answered between steps, so N instances run
    at once and the router only feeds and drains them.

    Backpressure: a submit that finds no free slot and a full queue
    (``max_queue``, default 2 x slots) answers ``("defer", None)``; the
    router holds the request and retries it on a later pump."""
    is_engine = isinstance(obj, engine_mod.ServingEngine)
    if is_engine and max_queue is None:
        max_queue = 2 * obj.slots
    listener = port if isinstance(port, Listener) else \
        worker_listener(port, host=host, authkey=authkey)
    with listener:
        if port_fd is not None:
            with os.fdopen(port_fd, "w") as f:
                f.write(f"{listener.address[1]}\n")
        with listener.accept() as conn:
            if is_engine:
                _engine_loop(obj, conn, max_queue)
            else:
                _prefill_loop(obj, conn)


def _engine_loop(eng, conn, max_queue: int):
    done: List[dict] = []
    step_times: List[float] = []
    seconds = {"inject": 0.0}      # unpacking and importing snapshots
    like = None
    while True:
        busy = any(r is not None for r in eng._active) or eng._queue
        if conn.poll(0.0 if busy else 0.02):
            try:
                cmd, payload = conn.recv()
            except EOFError:
                return                       # the router went away
            if cmd == "submit":
                if eng._draining:
                    conn.send(("draining", None))
                elif eng.free_slots == 0 and eng.queue_len >= max_queue:
                    conn.send(("defer", None))
                else:
                    conn.send(("ok",
                               eng.submit(request_from_wire(payload))))
            elif cmd == "poll":
                conn.send(("ok", done))
                done = []
            elif cmd == "stats":
                st = eng.load()
                st["step_times"] = step_times
                st["decode_steps"] = eng.decode_steps
                st["launches"] = kernel_launches()
                st["seconds"] = dict(seconds)
                step_times = []
                conn.send(("ok", st))
            elif cmd == "inject":
                if eng._draining:
                    conn.send(("draining", None))
                elif eng.free_slots == 0:
                    conn.send(("defer", None))
                else:
                    t0 = time.perf_counter()
                    if like is None:
                        like = snapshot_like(eng.cfg, eng.capacity)
                    rid = eng.import_snapshot(unpack_snapshot(payload, like))
                    seconds["inject"] += time.perf_counter() - t0
                    conn.send(("ok", rid))
            elif cmd == "drain":
                try:
                    snaps, queued = eng.drain()
                except NotImplementedError as e:
                    conn.send(("err", str(e)))
                    continue
                conn.send(("ok", ([pack_snapshot(s) for s in snaps],
                                  [request_to_wire(q) for q in queued])))
            elif cmd == "ping":
                conn.send(("ok", "pong"))
            elif cmd == "shutdown":
                conn.send(("ok", None))
                return
            else:
                conn.send(("err", f"unknown command {cmd!r}"))
        elif busy:
            t0 = time.perf_counter()
            finished = eng.step()
            step_times.append(time.perf_counter() - t0)
            done.extend(result_to_wire(r) for r in finished)


def _prefill_loop(pw, conn):
    # where a prefill's time goes: the forward and the copy to the host,
    # packing, and sending (until the router has taken the snapshot)
    seconds = {"prefill": 0.0, "pack": 0.0, "send": 0.0}
    while True:
        try:
            cmd, payload = conn.recv()
        except EOFError:
            return
        if cmd == "prefill":
            t0 = time.perf_counter()
            snap = pw.prefill(payload)
            t1 = time.perf_counter()
            buf = pack_snapshot(snap)
            t2 = time.perf_counter()
            conn.send(("ok", buf))
            seconds["prefill"] += t1 - t0
            seconds["pack"] += t2 - t1
            seconds["send"] += time.perf_counter() - t2
        elif cmd == "stats":
            conn.send(("ok", {"prefills": pw.prefills, "free_slots": 0,
                              "queue_len": 0, "active": 0,
                              "draining": False, "step_times": [],
                              "launches": kernel_launches(),
                              "seconds": dict(seconds)}))
        elif cmd == "ping":
            conn.send(("ok", "pong"))
        elif cmd == "shutdown":
            conn.send(("ok", None))
            return
        else:
            conn.send(("err", f"unknown command {cmd!r}"))


# --------------------------------------------------------------- handles ----

class InstanceHandle:
    """The router's end of one worker: a lazy socket and typed calls.
    Any transport failure (the worker died, the socket reset) surfaces
    as ``ConnectionError``, the router's death-handling boundary.

    A spawned worker's address is known once the worker has written its
    port to ``port_fd`` (the read end of a pipe), which it does when its
    model is built and it accepts."""

    def __init__(self, address=None, *, name: str = "",
                 authkey: bytes = AUTHKEY,
                 proc: Optional[subprocess.Popen] = None,
                 port_fd: Optional[int] = None):
        self.address = tuple(address) if address else None
        self.name = name or (f"{self.address[0]}:{self.address[1]}"
                             if self.address else f"worker:{proc.pid}")
        self.authkey, self.proc, self._port_fd = authkey, proc, port_fd
        self.dead = False
        self._conn = None

    def _read_port(self, deadline: float):
        """Wait for the worker's port on ``port_fd``."""
        line = b""
        while not line.endswith(b"\n"):
            left = deadline - time.monotonic()
            if left <= 0:
                raise ConnectionError(f"worker {self.name} not accepting "
                                      "in time")
            if not select.select([self._port_fd], [], [], min(left, 1.0))[0]:
                continue
            chunk = os.read(self._port_fd, 32)
            if not chunk:
                try:
                    code = self.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    code = None
                raise ConnectionError(f"worker {self.name} exited with "
                                      f"{code} before accepting")
            line += chunk
        os.close(self._port_fd)
        self._port_fd = None
        self.address = ("127.0.0.1", int(line))

    def connect(self, timeout: float = 120.0):
        deadline = time.monotonic() + timeout
        if self.address is None:
            self._read_port(deadline)
        while self._conn is None:
            try:
                self._conn = Client(self.address, authkey=self.authkey)
            except OSError:
                if self.proc is not None and self.proc.poll() is not None:
                    raise ConnectionError(
                        f"worker {self.name} exited with "
                        f"{self.proc.returncode} before accepting") from None
                if time.monotonic() > deadline:
                    raise ConnectionError(
                        f"worker {self.name} not accepting after "
                        f"{timeout:.0f}s") from None
                time.sleep(0.05)
        return self

    def call(self, cmd: str, payload=None):
        """-> (status, value), status one of 'ok', 'defer', 'draining'."""
        if self.dead:
            raise ConnectionError(f"instance {self.name} is dead")
        if self._conn is None:
            self.connect()
        try:
            self._conn.send((cmd, payload))
            status, val = self._conn.recv()
        except (EOFError, OSError) as e:
            raise ConnectionError(f"instance {self.name}: {e!r}") from e
        if status == "err":
            raise TierError(f"{self.name}: {val}")
        return status, val

    def stop(self):
        """Ask the worker to exit (``close`` waits for it)."""
        try:
            if not self.dead:
                self.call("shutdown")
        except (ConnectionError, TierError):
            pass

    def shutdown(self, timeout: float = 10.0):
        self.stop()
        self.close(timeout=timeout)

    def close(self, timeout: float = 10.0):
        if self._port_fd is not None:
            os.close(self._port_fd)
            self._port_fd = None
        if self._conn is not None:
            self._conn.close()
            self._conn = None
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


# -------------------------------------------------------------- spawning ----

def spawn_worker(role: str, model_args: List[str], *,
                 port: Optional[int] = None, env: Optional[dict] = None,
                 name: str = "", stdout=subprocess.DEVNULL) -> InstanceHandle:
    """Start ``python -m repro_torch.launch.serve --role <role> --port <p>
    <model_args>`` as a fresh child process and return its (unconnected)
    handle.  ``model_args`` are serve CLI flags: the flags that describe
    one engine describe each instance, which keeps a tier homogeneous
    (a handoff needs that).  Without ``port`` the worker binds any free
    port and reports it through a pipe (``--port-fd``), read at
    ``connect``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--role", role]
    read_fd = write_fd = None
    if port:
        cmd += ["--port", str(port)]
    else:
        read_fd, write_fd = os.pipe()
        cmd += ["--port", "0", "--port-fd", str(write_fd)]
    cmd += list(model_args)
    env = {**os.environ, **(env or {})}
    src_dir = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))     # .../src
    env["PYTHONPATH"] = src_dir + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.Popen(cmd, env=env, stdout=stdout,
                            stderr=subprocess.STDOUT,
                            pass_fds=() if write_fd is None else (write_fd,))
    if write_fd is not None:
        os.close(write_fd)          # the child holds its own copy
    return InstanceHandle(("127.0.0.1", port) if port else None, proc=proc,
                          port_fd=read_fd,
                          name=name or f"{role}:{port or proc.pid}")
